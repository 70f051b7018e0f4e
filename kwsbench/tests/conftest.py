"""Shared fixtures: tiny traffic for CPU runs of the harness, and the
card for the tests marked ``cuda`` (decided inside the fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TRAIN = {"rows": 48, "batch_size": 8, "seconds_per_row": 1.0,
              "max_steps_per_s": 4, "trace_from": 0, "trace_steps": 10}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def cpu_run(workload: str, seed: int = 2 ** 31 + 77, seconds: float = 0.5,
            trace: bool = False, overrides=None):
    """One run of ``workload`` on the CPU at a tiny size (the harness
    without its look for a card); returns (result, cell)."""
    import time

    from kwsbench import harness

    cell = harness.make_cell(workload, seed, seconds, trace,
                             time.perf_counter(),
                             traffic_overrides=dict(TINY_TRAIN,
                                                    **(overrides or {})))
    return harness.run(cell, require_cuda=False), cell
