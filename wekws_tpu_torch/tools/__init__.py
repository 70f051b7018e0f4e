"""Offline tools: the weight bridge from the JAX package, data-list
building (wav durations, ``make_list``) and kernel timing scripts."""
