"""Spans, the profiler window and its reduction.

The harness wraps each call it makes into the program in a ``span``;
with tracing on, a span is a ``torch.profiler.record_function`` range
named ``kwsbench.<name>``, so it lands on the profiler's clock beside
the device's records; with tracing off a span costs nothing.

``Profile`` traces a bounded steady part of the window (the profiler
loses records late in a long process) and reduces its Chrome trace to:

- ``kernels``: (name, start us, duration us) of every kernel;
- ``copies``: the same of every memcpy and memset, with its kind;
- ``spans``: the harness's ranges;
- ``window``: the traced range, the ``kwsbench.window`` span;
- ``busy_s``: the union of kernel, copy and set intervals inside it;
- the idle gaps between them, each named by the innermost harness span
  that the host was in when the gap began.
"""

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "kwsbench."


class Spans:
    """Spans around the harness's calls; inert unless ``on``."""

    def __init__(self, on: bool):
        self.on = on

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Reduced:
    """What the metrics read from one traced window."""

    def __init__(self, events: List[dict]):
        self.kernels: List[Tuple[str, float, float]] = []
        self.copies: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            rec = (e.get("name", ""), float(e.get("ts", 0.0)),
                   float(e.get("dur", 0.0)))
            if cat == "kernel":
                self.kernels.append(rec)
            elif cat in ("gpu_memcpy", "gpu_memset"):
                self.copies.append(rec)
            elif cat == "user_annotation" and rec[0].startswith(SPAN_PREFIX):
                self.spans.append((rec[0][len(SPAN_PREFIX):], rec[1],
                                   rec[2]))
        windows = [s for s in self.spans if s[0] == "window"]
        if not windows:
            raise RuntimeError("the trace holds no kwsbench.window span")
        _, w0, wd = windows[0]
        self.w0, self.w1 = w0, w0 + wd
        self.window_s = wd * 1e-6
        inside = [(max(ts, self.w0), min(ts + d, self.w1))
                  for _, ts, d in self.kernels + self.copies
                  if ts < self.w1 and ts + d > self.w0]
        self.busy = _merge(inside)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def in_window(self, records):
        return [r for r in records if r[1] >= self.w0 and r[1] < self.w1]

    def kernel_count(self) -> int:
        return len(self.in_window(self.kernels))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, _, d in self.in_window(self.kernels + self.copies):
            key = short_name(name)
            by[key] = by.get(key, 0.0) + d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps with no device work in the window,
        each named by the innermost harness span open at its start."""
        edges = [self.w0] + [x for ab in self.busy for x in ab] + [self.w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            host = [s for s in self.spans if s[0] != "window"
                    and s[1] <= a < s[1] + s[2]]
            name = min(host, key=lambda s: s[2])[0] if host else "outside"
            out.append([name, (b - a) * 1e-6])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    base = name
    if base.endswith(")"):
        depth = 0
        for i in range(len(base) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(base[i], 0)
            if depth == 0:
                base = base[:i]
                break
    if base.startswith("void "):
        base = base[5:]
    return base[:120]


class Profile:
    """``with Profile() as p:`` around the traced window; ``p.reduced``
    afterwards.  The Chrome trace goes to a temporary file under
    ``TMPDIR`` and is deleted once read."""

    def __init__(self):
        self.reduced: Optional[Reduced] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.reduced = Reduced(events)
        return False
