"""Device time of the fused training passes on the card, for the CUDA
source as it is, for variants of it and for other copies of it.

    python -m wekws_tpu_torch.tools.time_train_passes \
        [--passes f1,f2] [--precision bfloat16] [--variant NAME ...] \
        [--source NAME=PATH ...] [--shapes 512x198,512x598] [--rounds 2]

Builds ``csrc/fused_mdtc_train.cu`` ("source") and, for each named
variant, a copy of it with the variant's text edits (``VARIANTS``), and
each ``--source`` file as it is (another tree's copy of the file, such
as the parent commit's from ``git show HEAD~1:wekws_tpu_torch/csrc/
fused_mdtc_train.cu``, which has the same C interface), all ``nvcc``
runs at once, into ``wekws_tpu_torch/build/variants/``; while a variant
is timed, the wrapper's constants that mirror its edits are set to
match (``KNOBS``).  It prints each timed pass's registers and spills at
C = 32, 64 and 128 and, from ``cuobjdump -sass``, how many bf16
tensor-core (``HMMA``), fp32 FMA (``FFMA``) and all instructions its
C = 64 kernel holds.  Then, at each shape (B x T, or B x T x C, at C=64
unless given, K=5, dilation 8, inputs traced through the plain passes at
``--precision`` from seed 0; the flagship's main training shape is
512x198, the scale recipe's 512x598, and 64x198x128 is a C=128 model's),
each pass of each build is held against its plain version
(``compare_pass``, at bf16 with the pass's BF16_SUM_TOL; not the
``TIMING_ONLY`` variants, which leave work out) and timed: device time
per call of its kernel and its block reduction, from torch.profiler
over 20 launches (the reduction's share printed beside).  The builds
are timed in turns, first to last and back, ``--rounds`` times, in one
process on one card; the median of a build's rounds is printed.  Needs
a GPU and ``nvcc``.
"""

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

ZERO_ACC = "for (int j = 0; j < R; ++j) acc[j] = zero4;"
F1_STREAM = ("constexpr bool kF1Staged = true;",
             "constexpr bool kF1Staged = false;")
F1_ROWS1 = ("constexpr int kF1RowScale = 2;", "constexpr int kF1RowScale = 1;")
# name -> text edits (old, new) of csrc/fused_mdtc_train.cu; each old
# text must occur exactly once
VARIANTS = {
    # F2 and F3 without their cp.async window: the taps read from device
    # memory
    "no_stage": [(
        "const bool staged = fwd_smem_bytes<C, kF3>() + window <= "
        "kSmemLimit;",
        "const bool staged = false;")],
    # F2 and F3 at bf16 (one rule) without their window of x: the taps
    # read from device memory
    "f3_bf16_no_stage": [(
        "const bool staged = f3_bf16_staged<C>(halo);",
        "const bool staged = false;")],
    # B3 at bf16 without its window of x: x and the taps read from device
    # memory
    "b3_bf16_no_stage": [(
        "const bool staged = b3_bf16_staged<C>(halo);",
        "const bool staged = false;")],
    # F1 as one stream: no window, each thread reads its taps by __ldg
    # float4 from L1 and L2
    "f1_stream": [F1_STREAM],
    # F1's tiles as F2's rows (four rows a thread, not eight)
    "f1_rows1": [F1_ROWS1],
    # B1 with two or eight rows of a thread in flight, not four
    "b1_rows2": [("constexpr int kB1Rows = 4;", "constexpr int kB1Rows = 2;")],
    "b1_rows8": [("constexpr int kB1Rows = 4;", "constexpr int kB1Rows = 8;")],
    # F2 and F3 without their products, B2 without dr: what the
    # elementwise steps, the loads and the stores cost alone
    "no_products": [
        ("rows_product<C, R>(ta, w1, g, q, acc);", ZERO_ACC),
        ("rows_product<C, R>(tb, w2, g, q, acc);", ZERO_ACC),
        ("rows_product<C, R>(ta, w2t, g, q, dr);",
         ZERO_ACC.replace("acc", "dr"))],
    # B2 without dW2 += rᵀ·dwg
    "no_outer_b2": [(
        "rows_outer<C, ROWS, MB>(tr, ta, g, q, accw);", "")],
    # F2 at bf16 without its product (F3's body, bf16_forward, keeps
    # both of its own)
    "f2_bf16_no_product": [(
        "frag_product<C, LH>(af, w1h, acc, lane);  // v - b1 = s0 W1",
        "if constexpr (kFull) frag_product<C, LH>(af, w1h, acc, lane);")],
    # F3 at bf16 without its two products (F2 keeps its one), without
    # its stores of r and w, or F2 and F3 at bf16 (one body) with one
    # tap of their conv (the loads and FMAs of the others left out)
    "f3_bf16_no_products": [
        ("frag_product<C, LH>(af, w1h, acc, lane);  // v - b1 = s0 W1",
         "if constexpr (!kFull) frag_product<C, LH>(af, w1h, acc, lane);"),
        ("frag_product<C, LH>(af, w2h, acc, lane);  // w - b2 = r W2", "")],
    "f3_bf16_no_stores": [
        ("w4[static_cast<size_t>(rows[h]) * Q + 4 * m + tq] = w;", ""),
        ("            *reinterpret_cast<uint2*>(a.out_r16 +\n"
         "                                      static_cast<size_t>(rows[h]) "
         "* C +\n"
         "                                      16 * m + 4 * tq) =\n"
         "                make_uint2(af[m][h], af[m][2 + h]);", "")],
    "f3_bf16_one_tap": [(
        "#pragma unroll 1\n"
        "      for (int tap = first[0] < first[1] ? first[0] : first[1]; tap < a.K;\n"
        "           ++tap) {",
        "#pragma unroll 1\n"
        "      for (int tap = a.K - 1; tap < a.K;\n"
        "           ++tap) {")],
    # B3 at bf16 without its four products (dr and v, dW1, ds0), without
    # its stores of ds0, or with one tap of its conv
    "b3_bf16_no_products": [
        ("    for (int s = 0; s < NS; ++s) {\n      unsigned ag[4], as[4];",
         "    for (int s = 0; s < 0; ++s) {\n      unsigned ag[4], as[4];"),
        ("      for (int s = 0; s < ROWS / 16; ++s) {\n        unsigned af[4];",
         "      for (int s = 0; s < 0; ++s) {\n        unsigned af[4];"),
        ("    for (int s = 0; s < NS; ++s) {\n      unsigned ad[4];",
         "    for (int s = 0; s < 0; ++s) {\n      unsigned ad[4];")],
    "b3_bf16_no_stores": [(
        "ds04[static_cast<size_t>(rows[h]) * Q + 4 * (p0 + j) + tq] = ds0;",
        "")],
    "b3_bf16_one_tap": [(
        "          const int back = (a.K - 1 - tap) * a.d;\n"
        "          const float4 wk = VQ(kNumVec + tap, s);",
        "          if (tap != a.K - 1) continue;\n"
        "          const int back = 0;\n"
        "          const float4 wk = VQ(kNumVec + tap, s);")],
}
# the wrapper's mirror of a variant's edits (ops/fused_mdtc_train.py
# constants), set while that build is timed
KNOBS = {
    "f1_stream": {"F1_STAGED": False},
    "f1_rows1": {"F1_ROW_SCALE": 1},
}
# variants that leave work out: timed, not held against the plain version
TIMING_ONLY = ("no_products", "no_outer_b2", "f2_bf16_no_product",
               "f3_bf16_no_products", "f3_bf16_no_stores", "f3_bf16_one_tap",
               "b3_bf16_no_products", "b3_bf16_no_stores", "b3_bf16_one_tap")


def variant_text(source, name):
    """``source`` (csrc/fused_mdtc_train.cu's text) with the edits of
    variant ``name``; raises ValueError where an edit's old text does not
    occur exactly once."""
    for old, new in VARIANTS.get(name, ()):
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{source.count(old)} times")
        source = source.replace(old, new)
    return source


def build_variants(names, sources=()):
    """{build name: (library path, ptxas log)}: "source" is the file as
    it is, then each variant of it, then each (name, path) of
    ``sources`` as it is; every build runs at once."""
    from wekws_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    texts = {name: variant_text(source, name)
             for name in ("source",) + tuple(names)}
    for name, path in sources:
        if name in texts:
            raise ValueError(f"build {name!r} named twice")
        with open(path) as f:
            texts[name] = f.read()
    procs = {}
    for name, text in texts.items():
        src = os.path.join(out_dir, f"fused_mdtc_train_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libfused_mdtc_train_{name}.so")
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


def sass_counts(lib, kernels):
    """{kernel: (HMMA, FFMA, all)}: the instructions of each kernel's C =
    64 instantiation in the library's SASS (``cuobjdump -sass``)."""
    from wekws_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {k: [0, 0, 0] for k in kernels}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((k for k in kernels
                            if f"{len(k)}{k}ILi64E" in m.group(1)), None)
            continue
        if current is not None and re.match(r"\s+/\*[0-9a-f]+\*/", line):
            counts[current][0] += "HMMA" in line
            counts[current][1] += "FFMA" in line
            counts[current][2] += 1
    return {k: tuple(v) for k, v in counts.items()}


def device_ms(fn, kernel, pass_id, reps=20):
    """Mean device time per call of ``kernel`` and its reduction, and
    of the reduction alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = reduce = 0.0
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total",
                      getattr(evt, "cuda_time_total", 0.0))
        if f"reduce_kernel<{pass_id}>" in evt.key:
            reduce += dev
        elif kernel in evt.key:
            total += dev
    return (total + reduce) / reps / 1e3, reduce / reps / 1e3


def _source_arg(text):
    name, sep, path = text.partition("=")
    if not sep or not name or not path:
        raise argparse.ArgumentTypeError("expected NAME=PATH")
    return name, path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", default="f1,f2")
    ap.add_argument("--precision", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--source", action="append", default=[],
                    type=_source_arg,
                    help="NAME=PATH: another copy of fused_mdtc_train.cu")
    ap.add_argument("--shapes", default="512x198",
                    help="B x T (at C=64) or B x T x C, comma-separated")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops import fused_mdtc_train as fmt

    if not torch.cuda.is_available():
        print("time_train_passes: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    passes = args.passes.split(",")
    prec = args.precision
    names = {q: fmt.kernel_name(q, 64, prec).partition("<")[0]
             for q in passes}
    built = build_variants(args.variant, args.source)
    for name, (lib, log) in built.items():
        for entry, regs, st, ld in cuda_build.parse_ptxas_log(log):
            for kern in names.values():
                width = entry.partition(f"{len(kern)}{kern}ILi")[2]
                if width:
                    print(f"  {name}: {kern}<{width.partition('E')[0]}> "
                          f"{regs} registers, {st} bytes spill stores, {ld} "
                          f"bytes spill loads")
        for kern, (hmma, ffma, total) in sass_counts(
                lib, names.values()).items():
            print(f"  {name}: {kern}<64> SASS: {hmma} HMMA, {ffma} FFMA, "
                  f"{total} instructions", flush=True)
    shapes = [(tuple(int(v) for v in s.split("x")) + (64,))[:3]
              for s in args.shapes.split(",")]
    libs = {name: ctypes.CDLL(lib) for name, (lib, _) in built.items()}
    order = list(libs)
    times = {}
    for b, t, c in shapes:
        gen = torch.Generator().manual_seed(0)
        p, x, dy = fmt.seeded_block_inputs(gen, b, t, c, 5, "cuda")
        calls = fmt.trace_pass_inputs(x, p, dy, 8, precision=prec)
        for rnd in range(args.rounds):
            for name in order if rnd % 2 == 0 else order[::-1]:
                cuda_build._loaded["fused_mdtc_train"] = libs[name]
                knobs = KNOBS.get(name, {})
                saved = {k: getattr(fmt, k) for k in knobs}
                for k, v in knobs.items():
                    setattr(fmt, k, v)
                for q in passes:
                    fn = fmt.PASSES[q]
                    err = float("nan")
                    if name not in TIMING_ONLY:
                        tol = (fmt.BF16_SUM_TOL.get(q, fmt.SUM_TOL)
                               if prec == "bfloat16" else fmt.SUM_TOL)
                        err = fmt.compare_pass(q, fn(*calls[q]),
                                               fn.plain(*calls[q]), prec,
                                               tol)
                    ms, red = device_ms(lambda: fn(*calls[q]),
                                        fmt.kernel_name(q, c, prec),
                                        fmt.PASS_IDS[q])
                    times.setdefault((b, t, c, name, q), []).append(ms)
                    print(f"  B={b} x T={t} x C={c} round {rnd} {name} {q}: "
                          f"{ms:.4f} ms device per call, of it {red:.4f} "
                          f"ms its reduction, max abs err {err:.2e}",
                          flush=True)
                for k, v in saved.items():
                    setattr(fmt, k, v)
    cuda_build._loaded.pop("fused_mdtc_train", None)
    for b, t, c in shapes:
        for name in order:
            print(f"{name}: " + ", ".join(
                f"{q} {statistics.median(times[(b, t, c, name, q)]):.4f} ms"
                for q in passes) + f" (median of {args.rounds}; B={b} x "
                f"T={t} x C={c}, K=5, d=8, {prec}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
