"""Configuration and results IO, carried over from the JAX package."""
