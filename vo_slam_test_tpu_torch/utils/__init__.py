"""Small helpers without a counterpart module in the JAX package."""
