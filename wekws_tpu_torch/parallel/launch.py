"""Run a function on several local ranks of one process group.

``run_local(fn, world, args, device)`` starts ``world`` processes by
``spawn``, joins them into one group through ``mesh.distributed_init``
(a coordinator on a free port of 127.0.0.1; CUDA ranks on
``cuda:{rank % device_count}``), calls ``fn(rank, *args)`` in each and
returns their results in rank order.  A rank that raises, dies or
outlives ``timeout_s`` fails the whole run with every rank's traceback;
every process is joined or killed before it returns.  ``fn`` must be
importable by the spawned processes (a module-level function; under a
script, the script needs its ``if __name__ == "__main__":`` guard) and
return something picklable (numpy arrays, numbers).
"""

import multiprocessing as mp
import queue
import time
import traceback
from typing import Callable, List, Sequence

from wekws_tpu_torch.parallel.mesh import (
    distributed_close,
    distributed_init,
    free_port,
    rank_devices,
)


def _rank_main(fn, rank, world, port, device, args, results):
    try:
        distributed_init(f"127.0.0.1:{port}", world, rank, device)
        out = fn(rank, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        distributed_close()
    results.put((rank, True, out))


def run_local(fn: Callable, world: int, args: Sequence = (),
              device="cpu", timeout_s: float = 600.0) -> List:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each run by its own
    rank of a ``world``-process group on this machine."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    devices = rank_devices(device, world)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, devices[r], tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    outs, failures = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(outs) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(outs) - set(failures))
                failures["timeout"] = (f"ranks {late} gave no result within "
                                       f"{timeout_s} s")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in outs and r not in failures]
                if dead:
                    # a rank that died without reporting (killed); give
                    # the queue a moment for one that did report
                    time.sleep(1.0)
                    for r in dead:
                        if r not in outs and r not in failures:
                            failures[r] = (f"rank {r} exited with code "
                                           f"{procs[r].exitcode}")
                continue
            (outs if ok else failures)[rank] = out
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic())
                   if not failures else 5.0)
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
                failures.setdefault(r, f"rank {r} killed after the run")
        results.close()
    if failures:
        text = "\n".join(f"--- {k}:\n{v}" for k, v in sorted(
            failures.items(), key=lambda kv: str(kv[0])))
        raise RuntimeError(f"{len(failures)} of {world} ranks failed:\n"
                           f"{text}")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with codes "
                           f"{[procs[r].exitcode for r in bad]}")
    return [outs[r] for r in range(world)]
