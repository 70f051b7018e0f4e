"""The control on the card: the reference put in the program's place,
computed in the precision below the configuration's (TF32 for float32
products), must come out not correct under each cell's limits.  Smaller
than the cells (PERF.md gives the cells' own readings):
``python -m pytest -m cuda kwsbench/tests``."""

import time

import pytest

from kwsbench import calibrate, correct, harness

SMALLER = {"rows": 1024, "batch_size": 256}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202])
def test_control_is_not_correct(workload, seed, cuda_device):
    cell = harness.make_cell(workload, seed, 1, False, time.perf_counter(),
                             traffic_overrides=SMALLER)
    cell.device = cuda_device
    numbers = calibrate.control_train(cell, half=False)
    ok, checks = correct.judge(numbers, cell.limits)
    assert not ok, checks
