"""Helpers: the port's random generator (``prng``), the closed-form 3x3
inverse (``linalg``), the drift instrument (``drift``) and the device-side
control flow and captured step programs (``graphs``)."""
