"""Utilities: `convert` hands the JAX package's parameters and state to the port."""
