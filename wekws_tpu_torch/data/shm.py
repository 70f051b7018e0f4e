"""Shared-memory batch transport for DataLoader workers.

Copy of wekws_tpu/data/shm.py.  mp.Queue moves a batch by pickling
it (one serialize copy in the worker), pushing the bytes through a
pipe in 64 KB chunks (feeder thread + syscall ping-pong under the
GIL), and unpickling in the parent (another alloc+copy).  For ~33 MB int16 wave batches that
transport dominates worker scaling.

This module replaces the bulk bytes with POSIX shared memory: each
worker owns a small pool of segments; a batch's arrays are written
directly into a segment (one memcpy), and only a tiny descriptor
(segment name + per-array dtype/shape/offset + non-array fields)
travels through the queue.  The parent reconstructs numpy views,
copies them out (one memcpy — the views must not outlive the segment),
and returns the segment name through a free-queue.

Net: 2 memcpys and no GIL-bound chunked pipe, vs pickle's 3-4 copies.
"""

from multiprocessing import shared_memory
from typing import Dict, List, Tuple

import numpy as np


class SegmentPool:
    """Worker-side pool of reusable shared-memory segments, sized on
    demand (bucketed batches come in a few distinct sizes)."""

    def __init__(self, name_prefix: str, max_segments: int = 8):
        self.name_prefix = name_prefix
        self.max_segments = max_segments
        self.segments: Dict[str, shared_memory.SharedMemory] = {}
        self.free: List[str] = []
        self._counter = 0

    def acquire(self, nbytes: int) -> shared_memory.SharedMemory:
        """A free segment with size >= nbytes (smallest fit), or a new
        one.  Blocks the caller only through the free-queue drain done
        by the DataLoader (pool never exceeds max_segments)."""
        fits = [n for n in self.free if self.segments[n].size >= nbytes]
        if fits:
            name = min(fits, key=lambda n: self.segments[n].size)
            self.free.remove(name)
            return self.segments[name]
        if len(self.segments) >= self.max_segments and self.free:
            # recycle the largest free segment (too small): replace it
            name = max(self.free, key=lambda n: self.segments[n].size)
            self.free.remove(name)
            seg = self.segments.pop(name)
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
        self._counter += 1
        seg = shared_memory.SharedMemory(
            create=True, size=max(nbytes, 1),
            name=f"{self.name_prefix}_{self._counter}",
        )
        self.segments[seg.name] = seg
        return seg

    def release(self, name: str) -> None:
        if name in self.segments:
            self.free.append(name)

    def close(self, unlink: bool = True) -> None:
        for seg in self.segments.values():
            seg.close()
            if unlink:
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
        self.segments.clear()
        self.free.clear()


def pack(batch: Dict, pool: SegmentPool) -> Tuple[str, Dict]:
    """Write the batch's numpy arrays into a pool segment.

    Returns (segment_name, descriptor); the descriptor is tiny and
    queue-safe.  Non-array fields (keys lists etc.) ride inside it.
    """
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    total = sum(v.nbytes for v in arrays.values())
    seg = pool.acquire(total)
    off = 0
    spec = {}
    for k, v in arrays.items():
        dst = np.ndarray(v.shape, v.dtype, buffer=seg.buf, offset=off)
        dst[...] = v
        spec[k] = (str(v.dtype), v.shape, off)
        off += v.nbytes
    other = {k: v for k, v in batch.items() if k not in arrays}
    return seg.name, {"spec": spec, "other": other}


def unpack(name: str, desc: Dict, attached: Dict,
           cap: int = 64) -> Dict:
    """Parent side: copy arrays out of the (cached-attach) segment.

    Attachments are LRU-capped at ``cap`` (the loader passes the live
    working-set size, num_workers x pool size): workers unlink+replace
    segments when a bigger batch arrives, and a stale parent mapping
    would otherwise pin the dead segment's pages until close()
    (unbounded RSS across bucket-size churn)."""
    if name not in attached:
        if len(attached) >= cap:
            old_name = next(iter(attached))
            attached.pop(old_name).close()
        attached[name] = shared_memory.SharedMemory(name=name)
    else:
        attached[name] = attached.pop(name)  # LRU bump
    seg = attached[name]
    batch = dict(desc["other"])
    for k, (dtype, shape, off) in desc["spec"].items():
        view = np.ndarray(shape, np.dtype(dtype), buffer=seg.buf, offset=off)
        batch[k] = view.copy()  # view must not outlive the segment
    return batch


def detach_all(attached: Dict) -> None:
    for seg in attached.values():
        seg.close()
    attached.clear()
