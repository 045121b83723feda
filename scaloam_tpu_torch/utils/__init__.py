"""Numpy helpers of the port (no torch, no JAX)."""
