"""Kernel builder and the JAX weight bridge."""
