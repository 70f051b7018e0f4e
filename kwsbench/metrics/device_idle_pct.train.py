"""The share of the traced window with no kernel, copy or set running
on the card."""
from kwsbench import layers


def read(cell):
    return layers.idle_pct(cell)
