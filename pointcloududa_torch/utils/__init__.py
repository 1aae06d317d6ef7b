"""Kernel build, default device, device timing and the JAX weight bridge."""
