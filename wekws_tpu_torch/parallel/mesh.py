"""Data parallelism: one process per card, one step on the global batch.

Port of wekws_tpu/parallel/mesh.py.  The JAX package builds a 1-D
``('data',)`` mesh over every chip: the batch is one array sharded on
axis 0, the parameters are replicated, and XLA inserts the gradient
all-reduce.  Every batch statistic of exact BatchNorm, the loss's
``valid`` count and the gradient's global norm are therefore taken
over the GLOBAL batch.

Here each process owns one card (or shares one, below) and its rows of
the global batch; there is no global tensor, so ``make_global_batch``
and ``shard_batch`` have no counterpart: a rank keeps its local rows.
The same step comes from collectives in the glue, never inside a
kernel: the fused passes' per-channel sums and the module BatchNorm's
sums are all-reduced before they become statistics
(``ops/fused_mdtc_train.py``, ``models/layers.py``), the loss divides
by the all-reduced ``valid`` count, and the gradients are all-reduced
as one flat buffer before the optimizer (``train/steps.py``), so every
rank computes the same norm, the same skip and the same update.

Only ``all_reduce`` (sum) and ``broadcast`` are used: gloo has both for
CUDA tensors.  The backend follows from the layout, never from a
failure: ``join_group`` first joins a gloo group (the CPU's backend,
the rendezvous, and the host counts such as the fused passes' global
frame count), exchanges every rank's ``(hostname, device index)``, and
makes an NCCL group for the collectives only where each rank owns a
card.  Ranks that share a card (NCCL refuses two ranks
on one GPU) keep gloo on CUDA tensors.  A collective that fails raises.
"""

import datetime
import logging
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a collective (and the rendezvous) waits for its peers
TIMEOUT_S = 300.0

# the group the collectives run on: None is the default (gloo) group;
# an NCCL group where every rank owns a card.  Set by distributed_init.
_collectives = {"group": None, "backend": None}


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cpu",
) -> None:
    """Join ``num_processes`` processes at ``coordinator_address``
    (``host:port``; rank 0 listens there) as rank ``process_id``
    (``join_group``).  A no-op for one process, as the JAX package's
    is."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("--num_processes above 1 needs --coordinator "
                         "host:port and --process_id")
    join_group(coordinator_address, num_processes, process_id, device)


def join_group(coordinator_address: str, num_processes: int,
               process_id: int, device="cpu") -> None:
    """Make the process group, whatever its size (``distributed_init``
    skips one process; a one-rank group is a copy in every collective).
    The default group is gloo: the rendezvous, the CPU's collectives and
    the host counts (``all_reduce_count``).  ``device`` is this rank's:
    CUDA ranks exchange ``(hostname, card)`` over it and reduce over a
    new NCCL group where no two ranks share a card, else over gloo on
    CUDA tensors."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside "
                         f"[0, {num_processes})")
    dev = torch.device(device)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout)
    backend, group = "gloo", None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        layout = [None] * num_processes
        dist.all_gather_object(layout, (socket.gethostname(),
                                        torch.cuda.current_device()))
        if len(set(layout)) == num_processes:
            backend = "nccl"
            group = dist.new_group(backend="nccl", timeout=timeout)
        logging.info("rank %d of %d: cards %s -> collectives on %s",
                     process_id, num_processes, layout,
                     "nccl" if group is not None
                     else "gloo (ranks share a card)")
    else:
        logging.info("rank %d of %d: collectives on gloo (CPU)", process_id,
                     num_processes)
    _collectives.update(group=group, backend=backend)


def distributed_close() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        if _collectives["group"] is not None:
            dist.destroy_process_group(_collectives["group"])
        dist.destroy_process_group()
    _collectives.update(group=None, backend=None)


def is_distributed() -> bool:
    """Whether a process group is initialised: the collectives run."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def collective_backend() -> Optional[str]:
    """The backend the collectives run on, None without a group."""
    if not is_distributed():
        return None
    if _collectives["group"] is not None:
        return _collectives["backend"]
    return dist.get_backend()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank, as a new tensor (a copy in a
    one-rank group).  No gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, group=_collectives["group"])
    return out


def all_reduce_count(n: int) -> int:
    """The sum over every rank of the host integer ``n`` (a frame or row
    count), over the default gloo group: no device work and no wait on
    the card."""
    out = torch.tensor([int(n)], dtype=torch.int64)
    dist.all_reduce(out)
    return int(out.item())


def gather_counts(n: int) -> List[int]:
    """Every rank's host integer ``n``, in rank order, by one sum over
    the default gloo group of a vector that holds each rank's own entry
    (ghost BN's row offsets)."""
    out = torch.zeros((process_count(),), dtype=torch.int64)
    out[process_index()] = int(n)
    dist.all_reduce(out)
    return [int(v) for v in out.tolist()]


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward is the sum over ranks of the
    gradient: every rank's loss reads the summed statistic, so each
    rank's input receives the gradients of all of them."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad)


def all_reduce_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` through which autograd carries the gradient
    across ranks (the module BatchNorm's statistics)."""
    return _AllReduceSum.apply(x)


def broadcast_(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` in place with rank ``src``'s."""
    dist.broadcast(x, src, group=_collectives["group"])
    return x


def fold_rank(value: int, rank: int) -> int:
    """A seed for rank ``rank`` from the seed ``value`` of rank 0: rank
    0 keeps ``value`` (every one-process result stays as it is), other
    ranks draw other streams."""
    if rank == 0:
        return int(value)
    return (int(value) * 1000033 + int(rank)) % (2 ** 63)


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port the OS reports free on ``host`` (for a coordinator on
    this machine)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return int(s.getsockname()[1])


def pad_batch_to_multiple(
    batch: Dict[str, np.ndarray], multiple: int
) -> Dict[str, np.ndarray]:
    """Pad the batch dim to a multiple of ``multiple``, adding a
    ``valid`` 0/1 mask so padded rows can be excluded from metrics.
    Copy of the JAX package's (its rows hold no data: wave lengths of
    at least one frame, target lengths 1)."""
    b = batch["waves"].shape[0]
    rem = (-b) % multiple
    out = dict(batch)
    if "valid" not in out:  # bucketed batches carry their own mask
        out["valid"] = np.ones((b,), np.float32)
    if rem == 0:
        return out
    for key, val in list(out.items()):
        if isinstance(val, np.ndarray) and val.ndim >= 1 and val.shape[0] == b:
            pad_width = [(0, rem)] + [(0, 0)] * (val.ndim - 1)
            out[key] = np.pad(val, pad_width)
        elif isinstance(val, list) and len(val) == b:
            out[key] = val + [val[-1]] * rem
    # padded rows must not produce NaNs: give them length >= 1 frame
    if "wave_lengths" in out:
        out["wave_lengths"][b:] = max(1, int(batch["wave_lengths"].min()))
    if "target_lengths" in out:
        out["target_lengths"][b:] = 1
    return out


def rank_devices(device, world: int) -> Sequence[str]:
    """Each local rank's device: ``cuda:{rank % device_count}`` for
    CUDA (so ranks share cards when there are fewer cards than ranks),
    else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return ["cpu"] * world
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("CUDA ranks requested but no GPU is visible")
    return [f"cuda:{r % n}" for r in range(world)]


def mesh_devices(n: int, device="cuda") -> List[torch.device]:
    """The devices an engine splits its streams over for
    ``--mesh_devices n`` (the counterpart of ``make_mesh(n)``): ``n``
    cards from ``device``'s index on (``cuda`` and ``cuda:0`` from the
    first), or the CPU (one device).  Asking for more devices than the
    machine has from there raises, where the JAX package quietly takes
    ``jax.devices()[:n]``."""
    dev = torch.device(device)
    first = dev.index or 0
    count = (torch.cuda.device_count() - first if dev.type == "cuda"
             else 1)
    if not 1 <= n <= count:
        raise ValueError(f"--mesh_devices {n}: this machine has {count} "
                         f"{dev.type} device(s) from {dev}")
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", first + i) for i in range(n)]
