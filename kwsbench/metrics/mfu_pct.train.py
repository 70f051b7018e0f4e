"""The model's operations of the traced steps (forward and backward,
three times the forward) over the traced wall time at the peak of the
configuration's training products."""
from kwsbench import layers


def read(cell):
    return layers.mfu_pct(cell, 3, cell.config["precision"]["train_products"])
