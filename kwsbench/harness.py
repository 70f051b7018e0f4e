"""One run of one cell, driven by ``BENCHMARK.json`` and data files.

A cell names a configuration and a traffic mix.  The harness finds, by
those names:

- ``kwsbench/configs/<config>.json``: the configuration as it is run;
- ``kwsbench/traffic/<traffic>.json``: the mix's sizes, and its
  ``kind``, the driver ``kwsbench/drivers/<kind>.py`` that runs it;
- ``kwsbench/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
- ``kwsbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(cell) -> float | None``.

A driver sets up the program, measures for ``seconds``, then checks
what the timed path produced against ``kwsbench/reference``.  It fills
``cell.e2e`` (the end-to-end metrics), ``cell.layer`` (what the readers
read: the reduced trace and the harness's counters), ``cell.numbers``
and ``cell.attempted`` / ``cell.failed``.
"""

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from kwsbench import correct
from kwsbench.trace import Spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "kwsbench")
BANNED = ("jax", "jaxlib", "flax", "wekws_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    t0: float
    device: object = None
    spans: Spans = None
    e2e: Dict[str, float] = field(default_factory=dict)
    layer: dict = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)
    info: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0

    def setup_done(self) -> None:
        self.e2e["setup_s"] = time.perf_counter() - self.t0


def make_cell(name: str, seed: int, seconds: float, trace: bool,
              t0: float, bench: Optional[dict] = None,
              traffic_overrides: Optional[dict] = None) -> Cell:
    bench = manifest() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"kwsbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    traffic.update(traffic_overrides or {})
    return Cell(name=name, seed=int(seed), seconds=float(seconds),
                trace=bool(trace), bench=bench, workload=w,
                config=load_json(os.path.join(HERE, "configs",
                                              w["config"] + ".json")),
                traffic=traffic,
                limits=load_json(os.path.join(HERE, "limits",
                                              name + ".json"))["limits"],
                t0=t0, spans=Spans(bool(trace)))


def driver(kind: str):
    return importlib.import_module(f"kwsbench.drivers.{kind}")


def layer_metrics(cell: Cell) -> list:
    """The per-layer metrics this cell reports: those that list it, or
    that list no cells and move an end-to-end metric it reports."""
    out = []
    for m in cell.bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and cell.name in cells:
            out.append(m)
        elif cells is None and m["moves"] in cell.e2e:
            out.append(m)
    return out


def reader(name: str):
    """The module ``kwsbench/metrics/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "kwsbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, cell: Cell) -> Optional[float]:
    return reader(name).read(cell)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def device_info(cell: Cell) -> dict:
    import torch

    gpu = cell.device.type == "cuda"
    info = {"platform": "gpu" if gpu else "cpu",
            "kind": torch.cuda.get_device_name(cell.device) if gpu else "cpu",
            "count": 1, "memory_peak_bytes": int(cell.memory_peak)}
    if cell.trace and cell.layer.get("trace") is not None:
        red = cell.layer["trace"]
        info["busy_s"] = red.busy_s
        info["window_s"] = red.window_s
    return info


def result(cell: Cell, ok: bool, checks: dict) -> dict:
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]
             + cell.bench["per_layer"]}
    metrics = {}
    if cell.trace:
        for m in layer_metrics(cell):
            v = read_metric(m["name"], cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in cell.bench["end_to_end"]:
            v = cell.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    out = {"correct": bool(ok), "attempted": cell.attempted,
           "failed": cell.failed, "metrics": metrics,
           "device": device_info(cell)}
    red = cell.layer.get("trace")
    if cell.trace and red is not None:
        out["breakdown"] = {"device_ops": red.top_ops(),
                            "idle_gaps": red.idle_gaps()}
    out["checks"] = checks
    return out


def run(cell: Cell, require_cuda: bool = True) -> dict:
    """Set up, measure, check; returns the result line's object.
    ``require_cuda=False`` (tests only) runs on the CPU."""
    import torch

    if require_cuda:
        chips = int(cell.workload.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            count = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            raise SystemExit(
                f"kwsbench: the cell needs {chips} CUDA device(s); "
                f"torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, device_count {count}")
        cell.device = torch.device("cuda", 0)
    else:
        cell.device = torch.device("cpu")
    driver(cell.traffic["kind"]).run(cell)
    ok, checks = correct.judge(cell.numbers, cell.limits,
                               extra_ok=cell.failed == 0)
    return result(cell, ok, checks)
