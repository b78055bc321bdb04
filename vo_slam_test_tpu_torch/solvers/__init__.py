"""Pose-only solver."""
