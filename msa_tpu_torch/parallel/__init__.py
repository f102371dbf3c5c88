"""Work distribution of the port (torch-free and jax-free host code)."""
