"""Multiprocess batch loading with persistent workers.

Copy of wekws_tpu/data/loader.py: the reference wekws's
DataLoader(num_workers=N, persistent workers) over its IterableDataset
(wekws/bin/train.py): N long-lived
worker processes each run a disjoint worker-shard of the host pipeline
(wav IO, resample, augmentation, batching) and push finished batches
to the parent.  Workers are spawned once and reused across epochs
(process startup costs seconds when site hooks import heavy
libraries); an epoch-command channel drives them.  Workers use the
'spawn' context so they never inherit the parent's CUDA context, and
import nothing of torch (data/__init__.py imports lazily);
``num_workers=0`` degrades to the in-process thread prefetcher.

Batch payloads move through POSIX shared memory by default (see
data/shm.py): only a tiny descriptor rides the queue, so a 33 MB wave
batch costs two memcpys instead of pickle's serialize/chunked-pipe/
unpickle round trip.  ``shm=False`` falls back to plain queue
pickling.

Two consumption modes, selected by the dataset's ``ordered`` flag:

* unordered (default): one shared bounded queue, batches yielded in
  arrival order — maximum throughput.
* ordered (bucket-scheduled datasets): each worker owns its own
  bounded queue and the parent reads them round-robin, so the emitted
  order IS the interleave of the per-worker schedules (the multi-host
  lockstep contract) AND a stalled worker back-pressures only itself —
  the fast workers block on their own full queues instead of ballooning
  parent memory.

Unlike the JAX package's loader, a worker that raises or dies fails the
epoch: its traceback (or exit code) is raised in the consumer and the
workers are torn down, where the JAX loader would wait forever on the
dead worker's queue.
"""

import multiprocessing as mp
import os
import queue as queue_mod
import threading
import traceback
from typing import Iterator, Optional

from wekws_tpu_torch.data.prefetch import Prefetcher

_DONE = "__epoch_done__"
# how often a materializer thread waiting on a worker checks that the
# worker is alive and the consumer still wants batches
_POLL_S = 1.0


class WorkerError:
    """Sent in place of a batch by a worker whose pipeline raised (or by
    the materializer of a worker that died): the consumer raises it."""

    def __init__(self, message: str):
        self.message = message


def _put(q, item, stop: threading.Event) -> bool:
    """``q.put(item)`` unless ``stop`` is set first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue_mod.Full:
            pass
    return False


def _worker_main(dataset, worker_id, num_workers, cmd_queue, out_queue,
                 free_queue, shm_segments):
    dataset.data_list.set_worker(worker_id, num_workers)
    pool = None
    if shm_segments:
        from wekws_tpu_torch.data.shm import SegmentPool, pack

        pool = SegmentPool(
            f"wekws{os.getpid()}w{worker_id}", max_segments=shm_segments
        )
    try:
        while True:
            epoch = cmd_queue.get()
            if epoch is None:
                break
            try:
                dataset.set_epoch(epoch)
                for batch in dataset:
                    if pool is None:
                        out_queue.put(batch)
                        continue
                    # reclaim consumed segments (block only when the
                    # pool is exhausted — bounded by in-flight batches)
                    while True:
                        try:
                            pool.release(free_queue.get_nowait())
                        except queue_mod.Empty:
                            break
                    if not pool.free and len(pool.segments) >= shm_segments:
                        pool.release(free_queue.get())
                    name, desc = pack(batch, pool)
                    desc["worker"] = worker_id
                    out_queue.put((name, desc))
            except Exception:
                out_queue.put(WorkerError(
                    f"loader worker {worker_id}, epoch {epoch}:\n"
                    f"{traceback.format_exc()}"))
                raise
            finally:
                out_queue.put(_DONE)
    finally:
        if pool is not None:
            pool.close()


class DataLoader:
    """Iterate a Dataset with worker-process parallelism.

    The per-worker shard split reproduces the reference's two-level
    rank/worker slicing, so the union over workers is exactly the rank
    shard.  NOTE: like torch's worker sharding, each worker drops its
    own remainder batch when drop_last is set."""

    def __init__(self, dataset, num_workers: int = 0, prefetch: int = 8,
                 shm: bool = True):
        self.dataset = dataset
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shm = shm
        self.ordered = bool(getattr(dataset, "ordered", False))
        self._epoch = 0
        self._procs: Optional[list] = None
        self._cmd_queues = None
        self._out_queues = None
        self._free_queues = None
        self._attached: dict = {}

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.dataset.set_epoch(epoch)

    def _ensure_workers(self):
        if self._procs is not None:
            return
        ctx = mp.get_context("spawn")
        if self.ordered:
            # per-worker bounded queues: round-robin read order +
            # per-worker backpressure
            self._out_queues = [
                ctx.Queue(maxsize=max(self.prefetch, 2))
                for _ in range(self.num_workers)
            ]
        else:
            shared = ctx.Queue(
                maxsize=max(self.prefetch, self.num_workers)
            )
            self._out_queues = [shared] * self.num_workers
        self._cmd_queues = [ctx.Queue() for _ in range(self.num_workers)]
        self._free_queues = [ctx.Queue() for _ in range(self.num_workers)]
        shm_segments = (max(self.prefetch, 2) + 2) if self.shm else 0
        self._procs = []
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker_main,
                args=(self.dataset, w, self.num_workers,
                      self._cmd_queues[w], self._out_queues[w],
                      self._free_queues[w], shm_segments),
                daemon=True,
            )
            p.start()
            self._procs.append(p)

    def close(self) -> None:
        if self._procs is None:
            return
        for q in self._cmd_queues:
            q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        if self._attached:
            from wekws_tpu_torch.data.shm import detach_all

            detach_all(self._attached)
        self._procs = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def _materialize_loop(self, mp_queue, out_queue, attached, procs,
                          stop):
        """Parent-side materializer thread: drains a worker queue,
        resolves shm descriptors (the 33 MB copy-out happens HERE, with
        the GIL released inside numpy's memcpy), and feeds a bounded
        thread queue.  One thread per worker: copies run in parallel
        across workers AND overlap with the consumer.  A dead worker
        among ``procs`` (the ones feeding ``mp_queue``) or a failure
        here becomes a ``WorkerError``; ``stop`` ends the thread."""
        from wekws_tpu_torch.data.shm import detach_all, unpack

        cap = max(self.prefetch, 2) + 10
        try:
            while not stop.is_set():
                try:
                    item = mp_queue.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    dead = [p for p in procs if not p.is_alive()]
                    if dead:
                        _put(out_queue, WorkerError(
                            f"a loader worker exited with code "
                            f"{dead[0].exitcode} during the epoch"), stop)
                        return
                    continue
                if isinstance(item, str) and item == _DONE:
                    _put(out_queue, _DONE, stop)
                    return
                if self.shm and not isinstance(item, WorkerError):
                    name, desc = item
                    batch = unpack(name, desc, attached, cap=cap)
                    self._free_queues[desc["worker"]].put(name)
                else:
                    batch = item
                _put(out_queue, batch, stop)
        except Exception:
            _put(out_queue, WorkerError(traceback.format_exc()), stop)
        finally:
            detach_all(attached)

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            yield from Prefetcher(self.dataset, self.prefetch)
            return
        self._ensure_workers()
        for q in self._cmd_queues:
            q.put(self._epoch)
        # one materializer thread per worker; per-thread attachment
        # caches (segments are worker-owned, no sharing or locking)
        if self.ordered:
            mat_queues = [
                queue_mod.Queue(maxsize=2) for _ in range(self.num_workers)
            ]
            sources = list(self._out_queues)
        else:
            shared_out = queue_mod.Queue(
                maxsize=max(self.prefetch, self.num_workers)
            )
            mat_queues = [shared_out] * self.num_workers
            sources = list(self._out_queues)  # all the same shared queue
        stop = threading.Event()
        threads = [
            threading.Thread(
                target=self._materialize_loop,
                args=(sources[w], mat_queues[w], {},
                      [self._procs[w]] if self.ordered else self._procs,
                      stop),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        done = [False] * self.num_workers
        failed = []

        def take(q):
            item = q.get()
            if isinstance(item, WorkerError):
                failed.append(item)
                raise RuntimeError(item.message)
            return item

        try:
            if not self.ordered:
                remaining = self.num_workers
                while remaining:
                    item = take(mat_queues[0])
                    if isinstance(item, str) and item == _DONE:
                        remaining -= 1
                        done[done.index(False)] = True
                    else:
                        yield item
                return
            next_w = 0
            while not all(done):
                if not done[next_w]:
                    item = take(mat_queues[next_w])
                    if isinstance(item, str) and item == _DONE:
                        done[next_w] = True
                    else:
                        yield item
                next_w = (next_w + 1) % self.num_workers
        finally:
            # abandoned epoch: drain until every materializer thread
            # has forwarded its _DONE, so workers finish and the loader
            # stays reusable; after a worker failure, tear down instead
            try:
                if not failed and self.ordered:
                    for w in range(self.num_workers):
                        while not done[w]:
                            if take(mat_queues[w]) == _DONE:
                                done[w] = True
                elif not failed:
                    remaining = done.count(False)
                    while remaining:
                        if take(mat_queues[0]) == _DONE:
                            remaining -= 1
            except RuntimeError:
                pass  # failed holds it; the consumer's own error stands
            if failed:
                stop.set()
                self.close()
            for t in threads:
                t.join(timeout=5)
