"""Kernels (CUDA wrappers) and plain tensor ops of the ORB front end and matcher."""
