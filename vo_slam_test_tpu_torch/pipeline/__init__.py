"""Per-frame tracking pipeline."""
