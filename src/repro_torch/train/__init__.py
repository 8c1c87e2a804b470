"""Checkpoints in the JAX package's npz format, and parameter interop."""
