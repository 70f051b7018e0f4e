"""Offline tools: the weight bridge from the JAX package."""
