"""The step thread's CPU time a training step over the traced steps."""
from kwsbench import layers


def read(cell):
    return layers.host_ms(cell)
