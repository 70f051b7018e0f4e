"""Device time of the fbank, MDTC and DS-TCN serving kernels on the card,
per variant.

    python -m wekws_tpu_torch.tools.time_serving_kernels [--rounds 3] \
        [--only fbank|mdtc|tcn] [--clocks] [--precision]

At the main path's shapes, each variant is held against the plain
version first (log-mel 1e-3 abs + 1e-4 rel; MDTC and DS-TCN output and
new cache 1e-4 abs + 1e-4 rel) and then timed: device time per call of the
variant's kernel from torch.profiler over 20 launches, the variants in
turns, first to last and back, ``--rounds`` times in one process; the
median of a variant's rounds is printed with the card's name and power
limit.

- ``fused_fbank`` at (512, 32000) waves, 40 mel bins (the training
  batch of the flagship recipe, n_fft 512): the FFT plan as it is (32
  frames a block), builds of csrc/fused_frontend.cu with 16 or 64
  (``FRAME_VARIANTS``: source edits, all ``nvcc`` at once), mel over
  every bin of every filter (dense bands, 41 KB of weights), and the
  dense-DFT plan (the call given the folded operator alone).
- ``fused_mdtc_forward`` at B=16 x T=198 (offline scoring of 16 2 s
  utterances, flagship widths: 17 layers, C=64, K=5): the plan (on an
  H100 a cluster of 6 blocks a row, each on an SM of its own), and
  through ``forced_plan``: clusters of 8 and 4 blocks two to an SM
  ("packed"), of 4, 7 and 8 one to an SM ("spread"), and the plan with
  the layer outputs in the device buffer, each sub-tile's window staged
  with its halo read from L2 ("staged") or only each tap's rows
  ("taps"),
  instead of the windows in shared memory and the halo through
  distributed shared memory.
- ``fused_mdtc_stream`` at B=16 x T=8 (one step of the 16-stream
  engine): the plan (one block a row, each product's depth split over
  two threads), without the split, the 8 frames split over a cluster of
  2 blocks, and the layer outputs in the device buffer ("staged",
  "taps").
- ``fused_ds_tcn`` (the same kernel body with the DS-TCN layer; 4
  layers, K=8, dilations 1, 2, 4, 8) at the hey_snips width (C=64) and
  the hi_xiaowen width (C=256, W streamed in slices), each at B=16 x
  T=198 (offline scoring, zero cache) and B=16 x T=8 (the engine's
  step): the plan and, as for MDTC, clusters of 8 and 4 packed, of 4,
  7 and 8 spread, the "staged" and "taps" windows and 4 rows a thread
  (at C=256 sub-tiles of 16 rows, each streaming all of W) offline;
  without the depth split, a cluster of 2, "staged" and "taps"
  streaming.

With ``--precision`` it measures the fbank FFT plan's log-mel error on
the flagship's synthetic batch (a 500 Hz tone in noise on every other
row, as ``chip_smoke.py`` trains on) against the three-matmul extractor
and against float64, at 40 mel bins (512 rows) and 80 (64 rows), for
the source as it is and for a build without the low bins
(``PRECISION_VARIANTS``: every bin from the FFT), beside the
extractor's own error against float64.

With ``--clocks`` it also builds copies of ``csrc/fused_frontend.cu``
and ``csrc/fused_mdtc.cu`` in which thread 0 of the first block adds
``clock64()`` deltas per phase (``CLOCK_EDITS``) into a device array,
and prints the cycles per call of each phase at the main shapes: where
a call's time goes.  Each counter costs a global read-modify-write of
its own (some hundreds of cycles).  Needs a GPU and ``nvcc``.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

FBANK_SHAPE = (512, 32000)
MDTC_OFFLINE = (16, 198)
MDTC_STREAM = (16, 8)
DILATIONS = (1,) + (1, 2, 4, 8) * 4
CHANNELS, KERNEL, STACK = 64, 5, 4


_CLK = ("if (threadIdx.x == 0 && blockIdx.x == 0) {{ const long long t_ = "
        "clock64(); g_clk[{0}] += t_ - clk_prev; clk_prev = t_; }}\n")


def _at(anchor, n, after=False):
    """The edit that adds counter n just before (or after) ``anchor``."""
    return anchor, (anchor + _CLK.format(n) if after
                    else _CLK.format(n) + anchor)


# source -> (phase names, (old, new) edits; each old text occurs once)
CLOCK_EDITS = {
    "fused_frontend": (
        ("loads (cp.async)", "dither", "low bins (folded operator)",
         "pre-chain", "FFT + power", "mel + log (+ DCT)"),
        [("namespace {\n", "namespace {\n__device__ long long g_clk[16];\n"),
         ("  const long long row0 = static_cast<long long>(blockIdx.x) * F;\n",
          "  const long long row0 = static_cast<long long>(blockIdx.x) * F;\n"
          "  long long clk_prev = clock64();\n"),
         _at("  cp_async_wait_all();\n  __syncthreads();\n", 0, after=True),
         _at("  // the lowest kLowBins bins by the folded operator", 1),
         _at("  // pre-chain, one warp for FW frames at once", 2),
         _at("  // complex FFT of the packed pairs", 3),
         _at("  // mel over each filter's bins", 4),
         _at("}\n\ntemplate <int LOG2N>\nint launch_fft", 5)]),
    "fused_mdtc": (
        ("prologue", "cluster.sync", "copies issued + waited",
         "halo + new cache", "window barrier", "conv", "conv barrier",
         "product 1", "hidden tile + barriers", "product 2", "epilogue",
         "end cluster.sync"),
        [("namespace {\n", "namespace {\n__device__ long long g_clk[16];\n"),
         ("  const int T = p.T, P = p.P;\n",
          "  const int T = p.T, P = p.P;\n  long long clk_prev = clock64();\n"),
         _at("  for (int l = 0; l < p.L; ++l) {\n", 0),
         _at("    const int buf = p.nbuf == 2", 1),
         _at("    const float* wl = sm + buf * s.wsize;\n", 2),
         _at("    for (int s0 = t0; s0 < t0 + nr; s0 += p.TR) {\n", 3),
         _at("      // causal dilated depthwise conv + bias (both halves", 4),
         _at("      __syncthreads();\n      float4 acc[RJ];", 5),
         _at("      float4 acc[RJ];\n      if constexpr (kSliced)", 6),
         _at("      if constexpr (Arch == kMdtc) {\n"
             "        __syncthreads();", 7),
         _at("        rows_product<C, RJ, S>(ta, w2, g, q, sh, acc);", 8),
         _at("#pragma unroll\n      for (int j = 0; j < RJ; ++j) {\n"
             "        const int r = g + j * G;\n        if (r < n && sh == 0",
             9),
         _at("    if (p.nbuf == 1 && l + 1 < p.L) {\n", 10),
         _at("  // no block leaves while a peer may still read its shared "
             "memory\n  cluster.sync();\n", 11, after=True)]),
}
_CLOCK_READER = """
extern "C" int read_clocks(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  static const long long zero[16] = {0};
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk));
  }
  return static_cast<int>(err);
}
"""


# fused_frontend.cu builds for --precision: (old, new) edits, each old
# text occurring once
PRECISION_VARIANTS = {
    "no_low_bins": [("fr[k] = k < kLowBins ? lowp[r * kLowBins + k] : pk[i];",
                     "fr[k] = pk[i];")],
}
# fused_frontend.cu builds of other frames a block (16 and 64 at n_fft
# 512)
_FLOATS = "constexpr int kFftFloats = 16384;"
FRAME_VARIANTS = {
    "fft_frames_half": [(_FLOATS, _FLOATS.replace("16384", "8192"))],
    "fft_frames2x": [(_FLOATS, _FLOATS.replace("16384", "32768"))],
}


def edited_source(source, edits, name):
    """The text of csrc/<source>.cu with ``edits`` ((old, new), each
    old text occurring once)."""
    from wekws_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_sources(texts):
    """{name: library path} of the CUDA sources ``texts`` ({name:
    text}), every ``nvcc`` started at once."""
    from wekws_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        built[name] = lib
    return built


def with_library(source, path, fn):
    """fn() with the wrappers of csrc/<source>.cu bound to the build at
    ``path`` meanwhile."""
    from wekws_tpu_torch.ops import cuda_build

    lib = ctypes.CDLL(path)

    def call():
        saved = cuda_build._loaded.get(source)
        cuda_build._loaded[source] = lib
        try:
            return fn()
        finally:
            cuda_build._loaded.pop(source)
            if saved is not None:
                cuda_build._loaded[source] = saved
    return call


def forced_plan(t, c, k, pad_max, cluster, spread=False, arch="mdtc",
                **fixed):
    """``fit_plan``'s plan for a cluster of ``cluster`` blocks of the
    layer ``arch`` with some of its fields set (``window``, ``splits``),
    the tile and the shared memory recomputed: a plan the wrapper would
    not choose, for ``fused_mdtc._launch`` or ``fused_tcn._launch``."""
    from wekws_tpu_torch.ops import fused_mdtc as fm

    plan = dict(fm.fit_plan(t, c, k, pad_max, cluster, spread, arch),
                **fixed)
    plan["tile"] = fm.row_groups(c, plan["splits"]) * plan["rows_per_thread"]
    smem = fm.mdtc_smem_bytes(t, c, k, pad_max, cluster,
                              plan["rows_per_thread"], plan["splits"],
                              plan["window"], plan["nbuf"], arch)
    if smem > fm.SMEM_LIMIT:
        raise ValueError(f"{fixed} does not fit a block: {smem} bytes")
    plan["smem"] = max(smem, fm.SPREAD_SMEM) if spread else smem
    return plan


def fbank_precision(card):
    """Max |log-mel error| of the FFT plan (as it is and each of
    PRECISION_VARIANTS) against the three-matmul extractor and against
    float64, and the extractor's own against float64."""
    import numpy as np
    import torch

    from wekws_tpu_torch.frontend.features import (
        FeatureExtractor,
        analysis_matrix,
    )
    from wekws_tpu_torch.frontend.kaldi import EPSILON, FrontendConfig

    rng = np.random.default_rng(0)
    n = FBANK_SHAPE[1]
    t = np.arange(n) / 16000
    waves = (rng.standard_normal(FBANK_SHAPE) * 300).astype(np.float32)
    waves[::2] += (4000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    builds = {"source": None}
    builds.update(build_sources({
        name: edited_source("fused_frontend", edits, name)
        for name, edits in PRECISION_VARIANTS.items()}))
    for n_mel, b in ((40, 512), (80, 64)):
        cfg = FrontendConfig(num_mel_bins=n_mel)
        fused = FeatureExtractor(cfg, use_fused=True)
        w = torch.as_tensor(waves[:b]).cuda()
        plain = FeatureExtractor(cfg)(w)[0].cpu().numpy()
        frames = np.lib.stride_tricks.sliding_window_view(
            waves[:b].astype(np.float64), cfg.frame_length,
            axis=1)[:, ::cfg.frame_shift]
        spec = frames @ analysis_matrix(cfg)
        nbin = spec.shape[-1] // 2
        power = spec[..., :nbin] ** 2 + spec[..., nbin:] ** 2
        ref = np.log(np.maximum(
            power @ fused._cpu["mel_t"].double().numpy(), EPSILON))
        print(f"fused_fbank precision M={n_mel} B={b}: three-matmul "
              f"extractor vs float64 {np.abs(plain - ref).max():.3e} "
              f"[{card}]", flush=True)
        for name, path in builds.items():
            run = lambda: fused(w)[0].cpu().numpy()  # noqa: E731
            got = (run() if path is None
                   else with_library("fused_frontend", path, run)())
            print(f"fused_fbank precision M={n_mel} B={b} FFT plan {name}: "
                  f"vs the extractor {np.abs(got - plain).max():.3e}, vs "
                  f"float64 {np.abs(got - ref).max():.3e} [{card}]",
                  flush=True)


def clock_texts():
    """{"<source>_clocks": text} of the clock builds."""
    return {f"{name}_clocks": edited_source(name, edits, name) + _CLOCK_READER
            for name, (_, edits) in CLOCK_EDITS.items()}


def phase_cycles(variants, libs, reps=20):
    """{variant: cycles per call of each phase} of the plan's variants
    ("fft", "... (plan)") through the clock builds ``libs``."""
    import torch

    out = {}
    for name, (kern, fn) in variants.items():
        if name != "fft" and "(plan)" not in name:
            continue
        source = "fused_frontend" if "fbank" in kern else "fused_mdtc"
        path = libs[f"{source}_clocks"]
        lib = ctypes.CDLL(path)
        lib.read_clocks.argtypes = [ctypes.c_void_p]
        lib.read_clocks.restype = ctypes.c_int
        buf = (ctypes.c_longlong * 16)()

        def run():
            fn()
            torch.cuda.synchronize()
            lib.read_clocks(buf)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            if lib.read_clocks(buf) != 0:
                raise RuntimeError("read_clocks failed")

        with_library(source, path, run)()
        phases = CLOCK_EDITS[source][0]
        out[name] = [(p, buf[i] / reps) for i, p in enumerate(phases)]
    return out


def device_ms(fn, kernel_name, reps=20):
    """Mean device time per call of the kernels whose name holds
    ``kernel_name``, or None when the profiler records no device time."""
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
        if kernel_name in evt.key and evt.count:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total / count / 1e3 if count and total else None


def fbank_variants(gen, device, libs):
    """{name: (kernel name, call)}, each checked against the plain
    version."""
    import torch

    from wekws_tpu_torch.frontend.features import FeatureExtractor
    from wekws_tpu_torch.frontend.kaldi import EPSILON, FrontendConfig
    from wekws_tpu_torch.ops import fused_frontend as ff

    cfg = FrontendConfig(num_mel_bins=40)
    fe = FeatureExtractor(cfg, use_fused=True)
    waves = (torch.randn(FBANK_SHAPE, generator=gen) * 1000).to(device)
    mats = fe._mats(waves.device)
    ops = fe.fft_operands(mats)
    dense_bands, dense_n = ff.mel_bands(fe._cpu["mel_t"], dense=True)
    dense_ops = dict(ops, bands=dense_bands.to(device), n_band=dense_n)
    want, _ = FeatureExtractor(cfg)(waves)

    def call(operands):
        return lambda: ff.fused_fbank(
            waves, mats["analysis"], mats["mel_t"], None,
            frame_length=cfg.frame_length, frame_shift=cfg.frame_shift,
            epsilon=EPSILON, **operands)

    out = {"fft": ("fused_fbank_kernel", call(ops))}
    for name in FRAME_VARIANTS:
        out[name] = ("fused_fbank_kernel",
                     with_library("fused_frontend", libs[name], call(ops)))
    out["fft_dense_mel"] = ("fused_fbank_kernel", call(dense_ops))
    # given the folded operator alone, the wrapper runs the dense plan
    out["dense_dft"] = ("fused_fbank_dense_kernel", call({}))
    for name, (_, fn) in out.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.allclose(got, want, atol=1e-3, rtol=1e-4):
            raise AssertionError(f"fused_fbank {name} disagrees with the "
                                 f"plain version")
    return out


def mdtc_variants(gen, device):
    """{name: (kernel name, call)}, each checked against the plain
    version."""
    import torch

    from wekws_tpu_torch.ops import fused_mdtc as fm

    n_layers, c, k = len(DILATIONS), CHANNELS, KERNEL
    pad = (k - 1) * max(DILATIONS)
    shapes = (((n_layers, k, c), 0.3), ((n_layers, c), 0.1),
              ((n_layers, c, c), c ** -0.5), ((n_layers, c), 0.1),
              ((n_layers, c, c), c ** -0.5), ((n_layers, c), 0.1))
    w = tuple((torch.randn(s, generator=gen) * sc).to(device)
              for s, sc in shapes)
    x_off = torch.randn((*MDTC_OFFLINE, c), generator=gen).to(device)
    b, t = MDTC_STREAM
    x_st = torch.randn((b, t, c), generator=gen).to(device)
    cache = torch.randn((n_layers, b, pad, c), generator=gen).to(device)
    want_off = fm.fused_mdtc_forward_plain(x_off, *w, DILATIONS, k, STACK)
    want_st = fm.fused_mdtc_stream_plain(x_st, cache, *w, DILATIONS, k,
                                         STACK)

    t_off, t_st = MDTC_OFFLINE[1], MDTC_STREAM[1]
    plan_off = fm.card_plan(*x_off.shape, k, pad)
    plan_st = fm.card_plan(*x_st.shape, k, pad)

    def offline(cluster=None, spread=None, **fixed):
        plan = forced_plan(
            t_off, c, k, pad, cluster or plan_off["cluster"],
            plan_off["spread"] if spread is None else spread, **fixed)
        return lambda: fm._launch(x_off, None, w, DILATIONS, k, STACK,
                                  plan)[0]

    def stream(cluster=None, **fixed):
        plan = forced_plan(t_st, c, k, pad, cluster or plan_st["cluster"],
                           plan_st["spread"], **fixed)
        return lambda: fm._launch(x_st, cache, w, DILATIONS, k, STACK, plan)

    out = {
        "offline (plan)": lambda: fm.fused_mdtc_forward(
            x_off, *w, DILATIONS, k, STACK),
        "offline cluster8 packed": offline(8, False),
        "offline cluster4 packed": offline(4, False),
        "offline cluster4 spread": offline(4, True),
        "offline cluster7 spread": offline(7, True),
        "offline cluster8 spread": offline(8, True),
        "offline staged": offline(window="staged"),
        "offline taps": offline(window="taps"),
        "stream (plan)": lambda: fm.fused_mdtc_stream(
            x_st, cache, *w, DILATIONS, k, STACK),
        "stream splits1": stream(splits=1),
        "stream cluster2": stream(2),
        "stream staged": stream(window="staged"),
        "stream taps": stream(window="taps"),
    }
    for name, fn in out.items():
        got = fn()
        torch.cuda.synchronize()
        if name.startswith("offline"):
            pairs = ((got, want_off),)
        else:
            pairs = ((got[0], want_st[0]), (got[1], want_st[1]))
        for a, b_ in pairs:
            if not torch.allclose(a, b_, atol=1e-4, rtol=1e-4):
                raise AssertionError(f"fused_mdtc {name} disagrees with the "
                                     f"plain version")
    return {name: ("fused_mdtc_kernel", fn) for name, fn in out.items()}


TCN_DILATIONS, TCN_KERNEL = (1, 2, 4, 8), 8
TCN_WIDTHS = (64, 256)  # hey_snips, hi_xiaowen


def tcn_variants(gen, device):
    """{name: (kernel name, call)} of the DS-TCN kernel at each of
    ``TCN_WIDTHS``, each checked against the plain version."""
    import torch

    from wekws_tpu_torch.ops import fused_tcn as ft

    n_layers, k, dil = len(TCN_DILATIONS), TCN_KERNEL, TCN_DILATIONS
    pad = (k - 1) * max(dil)
    out = {}
    for c in TCN_WIDTHS:
        w = tuple((torch.randn(s, generator=gen) * sc).to(device)
                  for s, sc in (((n_layers, k, c), 0.3), ((n_layers, c), 0.1),
                                ((n_layers, c, c), c ** -0.5),
                                ((n_layers, c), 0.1)))
        cases = {}
        for mode, (b, t) in (("offline", MDTC_OFFLINE),
                             ("stream", MDTC_STREAM)):
            x = torch.randn((b, t, c), generator=gen).to(device)
            cache = (torch.zeros((n_layers, b, pad, c), device=device)
                     if mode == "offline" else
                     torch.randn((n_layers, b, pad, c), generator=gen)
                     .to(device))
            plan = ft.fused_mdtc.card_plan(b, t, c, k, pad, "ds_tcn")
            cases[mode] = (x, cache, plan,
                           ft.fused_ds_tcn_plain(x, cache, *w, dil, k))

        def forced(mode, cluster=None, spread=None, *, w=w, **fixed):
            x, cache, plan, _ = cases[mode]
            plan = forced_plan(
                x.shape[1], c, k, pad, cluster or plan["cluster"],
                plan["spread"] if spread is None else spread, "ds_tcn",
                **fixed)
            return lambda: ft._launch(x, cache, w, dil, k, plan)

        def planned(mode, w=w):
            x, cache, _, _ = cases[mode]
            return lambda: ft.fused_ds_tcn(x, cache, *w, dil, k)

        makers = {
            "offline (plan)": lambda: planned("offline"),
            "offline cluster8 packed": lambda: forced("offline", 8, False),
            "offline cluster4 packed": lambda: forced("offline", 4, False),
            "offline cluster4 spread": lambda: forced("offline", 4, True),
            "offline cluster7 spread": lambda: forced("offline", 7, True),
            "offline cluster8 spread": lambda: forced("offline", 8, True),
            "offline staged": lambda: forced("offline", window="staged"),
            "offline taps": lambda: forced("offline", window="taps"),
            "offline rows4": lambda: forced("offline", rows_per_thread=4),
            "stream (plan)": lambda: planned("stream"),
            "stream splits1": lambda: forced("stream", splits=1),
            "stream cluster2": lambda: forced("stream", 2),
            "stream staged": lambda: forced("stream", window="staged"),
            "stream taps": lambda: forced("stream", window="taps"),
        }
        for name, make in makers.items():
            try:
                fn = make()
            except ValueError as err:  # the variant does not fit a block
                print(f"fused_ds_tcn C={c} {name}: skipped, {err}",
                      flush=True)
                continue
            want = cases[name.split()[0]][3]
            got = fn()
            torch.cuda.synchronize()
            for a, b_ in zip(got, want):
                if not torch.allclose(a, b_, atol=1e-4, rtol=1e-4):
                    raise AssertionError(f"fused_ds_tcn C={c} {name} "
                                         f"disagrees with the plain version")
            out[f"C={c} {name}"] = ("fused_ds_tcn_kernel", fn)
    return out


def time_variants(variants, rounds=3):
    """{name: median device ms per call} over ``rounds`` rounds in turns."""
    times = {name: [] for name in variants}
    order = list(variants)
    for rnd in range(rounds):
        for name in order if rnd % 2 == 0 else order[::-1]:
            kern, fn = variants[name]
            times[name].append(device_ms(fn, kern))
    return {name: (statistics.median(v) if None not in v else None)
            for name, v in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", choices=("fbank", "mdtc", "tcn"))
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--precision", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_serving_kernels: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    if args.precision:
        fbank_precision(card)
    gen = torch.Generator().manual_seed(0)
    texts = {}
    if args.only in (None, "fbank"):
        texts.update({name: edited_source("fused_frontend", edits, name)
                      for name, edits in FRAME_VARIANTS.items()})
    if args.clocks:
        texts.update(clock_texts())
    libs = build_sources(texts)
    groups = {"fbank": (fbank_variants, f"fused_fbank {FBANK_SHAPE} M=40"),
              "mdtc": (mdtc_variants, "fused_mdtc B=16"),
              "tcn": (tcn_variants, "fused_ds_tcn B=16")}
    for key, (make, title) in groups.items():
        if args.only not in (None, key):
            continue
        variants = (make(gen, "cuda", libs) if key == "fbank"
                    else make(gen, "cuda"))
        got = time_variants(variants, args.rounds)
        for name, ms in got.items():
            txt = "not measured" if ms is None else f"{ms:.4f} ms"
            print(f"{title} {name}: device {txt} per call (median of "
                  f"{args.rounds}) [{card}]", flush=True)
        if key in ("mdtc", "tcn"):
            from wekws_tpu_torch.ops import fused_mdtc as fm

            arch = "mdtc" if key == "mdtc" else "ds_tcn"
            for shape, plan in fm._plans.items():
                if shape[0] == arch:
                    print(f"{title} plan at (B, T, C, K, pad_max) "
                          f"{shape[1:6]}: {plan}", flush=True)
        if args.clocks:
            for name, cycles in phase_cycles(variants, libs).items():
                print(f"{title} {name} cycles per call by phase (thread 0 "
                      f"of block 0; total {sum(c for _, c in cycles):.0f}): "
                      + "; ".join(f"{p} {c:.0f}" for p, c in cycles)
                      + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
