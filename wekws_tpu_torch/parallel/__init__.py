"""Data parallelism over processes (port of wekws_tpu/parallel)."""

from wekws_tpu_torch.parallel.mesh import (
    all_reduce_count,
    all_reduce_sum,
    all_reduce_sum_grad,
    broadcast_,
    distributed_close,
    distributed_init,
    is_distributed,
    join_group,
    pad_batch_to_multiple,
    process_count,
    process_index,
)

__all__ = [
    "all_reduce_count",
    "all_reduce_sum",
    "all_reduce_sum_grad",
    "broadcast_",
    "distributed_close",
    "distributed_init",
    "is_distributed",
    "join_group",
    "pad_batch_to_multiple",
    "process_count",
    "process_index",
]
