"""Helpers: the port's random generator (``prng``), the closed-form 3x3
inverse (``linalg``) and the drift instrument (``drift``)."""
