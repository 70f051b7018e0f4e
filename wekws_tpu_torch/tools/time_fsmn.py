"""Device time of the fused FSMN layer chain on the card, per variant.

    python -m wekws_tpu_torch.tools.time_fsmn [--rounds 3] [--clocks] \
        [--source-variant NAME ...]

At the hi_xiaowen widths (4 layers, linear_dim 250, proj_dim 128,
orders 10/2, seed 0) and the main path's two shapes, the engine's
chunk B=1 x T=10 and the offline B=16 x T=66, each variant of
``fused_fsmn_layers`` is held against the plain version (1e-4 abs +
1e-4 rel) and timed: device time per call of ``fused_fsmn_kernel``
from torch.profiler over 20 launches, weights packed once as
``build_fused_forward`` packs them, the variants in turns, first to
last and back, ``--rounds`` times in one process; the median of a
variant's rounds is printed.  The variants: the source as it is with
clusters of 8 blocks (``CLUSTER``) and of 16 (``KNOBS``), and a build
of each ``--source-variant`` (``SOURCE_VARIANTS``: text edits of the
source).  With ``--clocks`` it also builds a copy of
``csrc/fused_fsmn.cu`` in which thread 0 of the first block adds
``clock64()`` deltas per phase of the kernel (``PHASES``) into a device
array, and prints the cycles per call of each phase at both shapes:
where a call's time goes.  Needs a GPU and ``nvcc``.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

# name -> the wrapper's constants (ops/fused_fsmn.py) set while the
# source as it is is timed
KNOBS = {"cluster8": {}, "cluster16": {"CLUSTER": 16}}
SHAPES = ((1, 10), (16, 66))  # the engine's chunk, the offline batch
N_LAYERS, LINEAR_DIM, PROJ_DIM, LORDER, RORDER = 4, 250, 128, 10, 2


# phases of one kernel call, each ending where its counter (the index)
# is added
PHASES = ("start: first cluster.sync", "layers 1..: weights wait",
          "a: cur rows", "b: proj product", "c: taps + o gather",
          "d: cluster.sync", "e: aff product", "e: y stores",
          "f: window shift", "new cache", "layer end sync",
          "layer 0: weights wait", "start: zero + first copies")
# builds of csrc/fused_fsmn.cu with text edits (old, new; each old text
# occurs once), timed beside the source as it is with the default knobs
SOURCE_VARIANTS = {
    "splits8": [("constexpr int kSplits = 4;", "constexpr int kSplits = 8;")],
    # every batch on the kernel planned for one block an SM, or for two
    "one_block": [("constexpr int kOneBlockBatch = 8;",
                   "constexpr int kOneBlockBatch = 1 << 30;")],
    "two_blocks": [("constexpr int kOneBlockBatch = 8;",
                    "constexpr int kOneBlockBatch = 0;")],
}
_CLK = ("if (threadIdx.x == 0 && blockIdx.x == 0) {{ const long long t_ = "
        "clock64(); g_clk[{0}] += t_ - clk_prev; clk_prev = t_; }}\n")


def _before(anchor, n):
    """The edit that adds counter n just before ``anchor``."""
    return anchor, _CLK.format(n) + anchor


# (old, new) edits of csrc/fused_fsmn.cu for the clock build; each old
# text occurs once
CLOCK_EDITS = [
    ("namespace {\n", "namespace {\n__device__ long long g_clk[16];\n"),
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  long long clk_prev = clock64();\n"),
    ("  cluster.sync();\n\n", "  cluster.sync();\n" + _CLK.format(0)),
    ("    __syncthreads();     // (every thread's)\n",
     "    __syncthreads();\n" + _CLK.format("l == 0 ? 11 : 1")),
    _before("  // no block writes into a peer's shared memory before", 12),
    _before("      // b. p = cur", 2),
    _before("      // c. the memory taps", 3),
    _before("      // d. every block", 4),
    _before("      // e. y = relu", 5),
    _before("      const float* bias = wb", 6),
    _before("      // f. the window", 7),
    _before("      float* tmp = win;", 8),
    _before("    // this layer's y is everywhere", 9),
    ("    cluster.sync();\n  }\n}\n",
     "    cluster.sync();\n" + _CLK.format(10) + "  }\n}\n"),
]
_CLOCK_READER = """
extern "C" int fsmn_read_clocks(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  static const long long zero[16] = {0};
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk));
  }
  return static_cast<int>(err);
}
"""


def build_sources(names):
    """{build name: (library path, ptxas log)} for "source" (the file as
    it is), the named SOURCE_VARIANTS and, for "clocks", the clock build;
    every ``nvcc`` runs at once."""
    from wekws_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_fsmn.cu")) as f:
        source = f.read()
    procs = {}
    for name in ["source"] + list(names):
        text = source
        edits = (CLOCK_EDITS if name == "clocks"
                 else SOURCE_VARIANTS.get(name, []))
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                                 f"times")
            text = text.replace(old, new)
        if name == "clocks":
            text += _CLOCK_READER
        src = os.path.join(out_dir, f"fused_fsmn_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libfused_fsmn_{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        built[name] = (lib, log)
    return built


def _use_library(lib):
    """Make ``fused_fsmn_layers`` launch from ``lib`` (a CDLL), or from
    the library of the source as it is (None)."""
    from wekws_tpu_torch.ops import cuda_build

    if lib is None:
        cuda_build._loaded.pop("fused_fsmn", None)
    else:
        cuda_build._loaded["fused_fsmn"] = lib


def phase_cycles(lib_path, weights, orders, gen, device, reps=20,
                 shapes=SHAPES):
    """{(B, T): cycles per call of each of PHASES} from the clock build
    at ``lib_path`` (thread 0 of the first block; clusters of 8, weights
    packed as build_fused_forward packs them)."""
    import torch

    from wekws_tpu_torch.ops.fused_fsmn import (
        fused_fsmn_layers,
        pack_fsmn_weights,
    )

    lib = ctypes.CDLL(lib_path)
    lib.fsmn_read_clocks.argtypes = [ctypes.c_void_p]
    lib.fsmn_read_clocks.restype = ctypes.c_int
    _use_library(lib)
    n_layers, ld, pd = weights[0].shape
    pad = (orders[0] - 1) * orders[2] + orders[1] * orders[3]
    packed = pack_fsmn_weights(weights[0], weights[3])
    buf = (ctypes.c_longlong * 16)()
    out = {}
    try:
        for b, t in shapes:
            x = torch.randn((b, t, ld), generator=gen).to(device).relu()
            cache = torch.randn((n_layers, b, pad, pd),
                                generator=gen).to(device)
            fused_fsmn_layers(x, cache, *weights, *orders, packed=packed)
            torch.cuda.synchronize()
            lib.fsmn_read_clocks(buf)
            for _ in range(reps):
                fused_fsmn_layers(x, cache, *weights, *orders, packed=packed)
            torch.cuda.synchronize()
            if lib.fsmn_read_clocks(buf) != 0:
                raise RuntimeError("fsmn_read_clocks failed")
            out[(b, t)] = [buf[i] / reps for i in range(len(PHASES))]
    finally:
        _use_library(None)
    return out


def device_ms(fn, reps=20):
    """Mean device time per call of ``fused_fsmn_kernel``, or None when
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if "fused_fsmn_kernel" in evt.key and evt.count:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total / count / 1e3 if count and total else None


def time_variants(weights, orders, gen, device, rounds=3, shapes=SHAPES,
                  builds=None):
    """{(variant, (B, T)): median device ms per call} for each of
    ``KNOBS`` on the source as it is and for each of ``builds`` ({name:
    library path}, from ``build_sources``) at each shape; ``weights`` =
    (proj_w, wl, wr, aff_w, aff_b) on ``device``, ``orders`` = (lorder,
    rorder, lstride, rstride).  Raises where a variant disagrees with
    the plain version."""
    import torch

    from wekws_tpu_torch.ops import fused_fsmn as ff

    proj_w, wl, wr, aff_w, aff_b = weights
    n_layers, ld, pd = proj_w.shape
    pad = (orders[0] - 1) * orders[2] + orders[1] * orders[3]
    inputs = {}
    for b, t in shapes:
        x = torch.randn((b, t, ld), generator=gen).to(device).relu()
        cache = torch.randn((n_layers, b, pad, pd), generator=gen).to(device)
        want = ff.fused_fsmn_layers_plain(x, cache, *weights, *orders)
        inputs[(b, t)] = (x, cache, want)
    runs = [(name, None, knobs) for name, knobs in KNOBS.items()]
    runs += [(name, ctypes.CDLL(path), {})
             for name, path in (builds or {}).items()]
    calls = {}
    for name, lib, knobs in runs:
        saved = {k: getattr(ff, k) for k in knobs}
        for k, v in knobs.items():
            setattr(ff, k, v)
        packed = ff.pack_fsmn_weights(proj_w, aff_w)
        for k, v in saved.items():
            setattr(ff, k, v)
        for shape, (x, cache, want) in inputs.items():
            def call(x=x, cache=cache, lib=lib, knobs=knobs, packed=packed):
                _use_library(lib)
                saved = {k: getattr(ff, k) for k in knobs}
                for k, v in knobs.items():
                    setattr(ff, k, v)
                try:
                    return ff.fused_fsmn_layers(x, cache, *weights, *orders,
                                                packed=packed)
                finally:
                    for k, v in saved.items():
                        setattr(ff, k, v)
            got = call()
            torch.cuda.synchronize()
            for i in range(2):
                if not torch.allclose(got[i], want[i], atol=1e-4, rtol=1e-4):
                    raise AssertionError(f"fused_fsmn {name} B={shape[0]} "
                                         f"T={shape[1]} disagrees with the "
                                         f"plain version")
            calls[(name, shape)] = call
    times = {key: [] for key in calls}
    order = [run[0] for run in runs]
    for rnd in range(rounds):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for shape in inputs:
                times[(name, shape)].append(device_ms(calls[(name, shape)]))
    _use_library(None)
    return {key: (statistics.median(v) if None not in v else None)
            for key, v in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--source-variant", action="append", default=[],
                    choices=sorted(SOURCE_VARIANTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_fsmn: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(0)
    shapes = ((N_LAYERS, LINEAR_DIM, PROJ_DIM), (N_LAYERS, LORDER, PROJ_DIM),
              (N_LAYERS, RORDER, PROJ_DIM), (N_LAYERS, PROJ_DIM, LINEAR_DIM),
              (N_LAYERS, LINEAR_DIM))
    weights = tuple((torch.randn(s, generator=gen) * s[-2] ** -0.5
                     if len(s) == 3 else torch.randn(s, generator=gen) * 0.1)
                    .cuda() for s in shapes)
    from wekws_tpu_torch.ops import cuda_build

    built = build_sources(args.source_variant
                          + (["clocks"] if args.clocks else []))
    for name, (_, log) in built.items():
        for entry, regs, st, ld in cuda_build.parse_ptxas_log(log):
            if "fused_fsmn_kernel" in entry:
                print(f"  {name}: {entry[-48:]} {regs} registers, {st} bytes "
                      f"spill stores, {ld} bytes spill loads", flush=True)
    clocks = built.pop("clocks", (None,))[0]
    built.pop("source")
    got = time_variants(weights, (LORDER, RORDER, 1, 1), gen, "cuda",
                        args.rounds,
                        builds={k: v[0] for k, v in built.items()})
    for (name, (b, t)), ms in got.items():
        txt = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"fused_fsmn {name} B={b} T={t}: device {txt} per call "
              f"(median of {args.rounds}) [{card}]", flush=True)
    if clocks:
        for (b, t), cycles in phase_cycles(clocks, weights,
                                           (LORDER, RORDER, 1, 1), gen,
                                           "cuda").items():
            print(f"fused_fsmn cycles per call by phase, B={b} T={t} "
                  f"(thread 0 of block 0; total {sum(cycles):.0f}): "
                  + "; ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, cycles))
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
