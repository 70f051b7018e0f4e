"""Device time of the fused training passes on the card, for the CUDA
source as it is and for variants of it.

    python -m wekws_tpu_torch.tools.time_train_passes \
        [--passes f3,b2] [--variant NAME ...] [--rounds 2]

Builds ``csrc/fused_mdtc_train.cu`` and, for each named variant, a copy
of it with the variant's text edits (``VARIANTS``), all ``nvcc`` runs
at once, into ``wekws_tpu_torch/build/variants/``.  Then, at the
flagship's main training shape (B=512 x T=198 x C=64, K=5, dilation 8,
inputs traced through the plain passes from seed 0), each pass of each
build is held against its plain version (``compare_pass``; not the
``TIMING_ONLY`` variants, which leave work out) and timed:
device time per call of its kernel and its block reduction, from
torch.profiler over 20 launches.  The builds are timed in turns, first
to last and back, ``--rounds`` times, in one process on one card; the
median of a build's rounds is printed with its registers and spills.
Needs a GPU and ``nvcc``.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ZERO_ACC = "for (int j = 0; j < R; ++j) acc[j] = zero4;"
# name -> text edits (old, new) of csrc/fused_mdtc_train.cu; each old
# text must occur exactly once
VARIANTS = {
    # F3 without its cp.async window: the taps read from device memory
    "no_stage": [(
        "const bool staged = f3_smem_bytes<C>() + window <= kSmemLimit;",
        "const bool staged = false;")],
    # F3 without its two products, B2 without dr: what the elementwise
    # steps, the loads and the stores cost alone
    "no_products": [
        ("rows_product<C, R>(ta, w1, g, q, acc);", ZERO_ACC),
        ("rows_product<C, R>(tb, w2, g, q, acc);", ZERO_ACC),
        ("rows_product<C, R>(ta, w2t, g, q, dr);",
         ZERO_ACC.replace("acc", "dr"))],
    # B2 without dW2 += rᵀ·dwg
    "no_outer_b2": [(
        "rows_outer<C, ROWS, MB>(tr, ta, g, q, accw);", "")],
}
# variants that leave work out: timed, not held against the plain version
TIMING_ONLY = ("no_products", "no_outer_b2")


def build_variants(names):
    """{build name: (library path, ptxas log)}: "source" is the file as
    it is; every build runs at once."""
    from wekws_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    procs = {}
    for name in ("source",) + tuple(names):
        text = source
        for old, new in VARIANTS.get(name, ()):
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} occurs "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
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


def device_ms(fn, kernel, pass_id, reps=20):
    """Mean device time per call of ``kernel`` and its reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key or f"reduce_kernel<{pass_id}>" in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / reps / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", default="f3,b2")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
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
    built = build_variants(args.variant)
    for name, (_, log) in built.items():
        for entry, regs, st, ld in cuda_build.parse_ptxas_log(log):
            for p in passes:
                kern = fmt.kernel_name(p, 64).partition("<")[0]
                if f"{kern}ILi64E" in entry:
                    print(f"  {name}: {kern}<64> {regs} registers, {st} "
                          f"bytes spill stores, {ld} bytes spill loads")
    gen = torch.Generator().manual_seed(0)
    p, x, dy = fmt.seeded_block_inputs(gen, 512, 198, 64, 5, "cuda")
    calls = fmt.trace_pass_inputs(x, p, dy, 8)
    libs = {name: ctypes.CDLL(lib) for name, (lib, _) in built.items()}
    order = list(libs)
    times = {(n, q): [] for n in order for q in passes}
    for rnd in range(args.rounds):
        for name in order if rnd % 2 == 0 else order[::-1]:
            cuda_build._loaded["fused_mdtc_train"] = libs[name]
            for q in passes:
                fn = fmt.PASSES[q]
                err = float("nan")
                if name not in TIMING_ONLY:
                    err = fmt.compare_pass(q, fn(*calls[q]),
                                           fn.plain(*calls[q]))
                ms = device_ms(lambda: fn(*calls[q]),
                               fmt.kernel_name(q, 64), fmt.PASS_IDS[q])
                times[(name, q)].append(ms)
                print(f"  round {rnd} {name} {q}: {ms:.4f} ms device per "
                      f"call, max abs err {err:.2e}", flush=True)
    cuda_build._loaded.pop("fused_mdtc_train", None)
    for name in order:
        print(f"{name}: " + ", ".join(
            f"{q} {statistics.median(times[(name, q)]):.4f} ms"
            for q in passes) + f" (median of {args.rounds}; B=512 x T=198 "
            f"x C=64, K=5, d=8) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
