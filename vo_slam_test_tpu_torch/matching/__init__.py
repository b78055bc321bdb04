"""Projection matching and the rotation-consistency filter."""
