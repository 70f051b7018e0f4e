#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (wekws_tpu_torch).

Drives the flagship MDTC max-pooling wake word (40-mel fbank, global
CMVN, linear preprocessing, MDTC 4 stacks x 4 blocks, kernel 5, 64
channels, linear head + sigmoid; random weights from a seed) on one
CUDA device, in phases; any failure exits non-zero:

1. card name and power limit (nvidia-smi); a GPU is required;
2. build every CUDA kernel from ``wekws_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at
   flagship width: whole-utterance forward at B=64 x T=198 and
   B=4 x T=1024, streaming at B=16 in chunks of 8 over 200 frames
   (chained, against the one-shot forward); bound 1e-4 abs + 1e-4 rel
   (fp32, another summation order);
4. the serving slice end to end: 16 synthetic 2 s utterances ->
   fbank -> checkpoint saved and loaded through ``load_serving_model``
   -> (a) offline ``build_fused_forward`` -> score file -> DET, held
   against the module forward; (b) ``BatchMaxPoolSpotter(use_fused=
   True)`` fed 300 ms chunks, stepped and flushed, held against (a).
   Kernel launch counts are zeroed before each path and read after;
5. kernel and plain times (CUDA events around one call, warm-up,
   median of 30 calls; the kernel's device time alone from
   torch.profiler) beside the bound computed from this run's shapes.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
CHANNELS = 64
FLAGSHIP_MODEL_CONF = {
    "input_dim": 40,
    "output_dim": 1,
    "hidden_dim": CHANNELS,
    "preprocessing": {"type": "linear"},
    "backbone": {
        "type": "mdtc", "num_stack": 4, "stack_size": 4,
        "kernel_size": 5, "hidden_dim": CHANNELS, "causal": True,
    },
}
DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
}
TOL = 1e-4  # abs and rel: fp32 with another summation order
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KEYWORD = "HI"
N_UTTS, SECONDS, RATE = 16, 2, 16000
CHUNK_SAMPLES = RATE * 300 // 1000


def phase(name):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[phase] {name} ...", flush=True)

        def __exit__(self, exc_type, exc, tb):
            status = "ok" if exc_type is None else "FAILED"
            print(f"[phase] {name} {status} "
                  f"({time.perf_counter() - self.t0:.1f} s)", flush=True)
            return False

    return _Phase()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def flagship_model(generator, cmvn=None):
    """Flagship KWSModel with seeded weights and BN statistics nudged
    so that folding is not the identity."""
    import torch

    from wekws_tpu_torch.models import init_model

    conf = dict(FLAGSHIP_MODEL_CONF)
    if cmvn is not None:
        conf["cmvn"] = {"mean": cmvn[0].tolist(), "istd": cmvn[1].tolist(),
                        "norm_var": True}
    model = init_model(conf, generator)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=generator))
            elif name.endswith("running_var"):
                buf.copy_(1.0 + 0.5 * torch.rand(buf.shape,
                                                 generator=generator))
    return model, conf


def cuda_time_ms(fn, reps=30, warmup=5):
    """Median of per-call CUDA-event times."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def profiled_device_ms(fn, kernel_name, reps=20):
    """Mean device time of the CUDA kernel ``kernel_name`` per call,
    from torch.profiler, or None when the profiler records no device
    time.  Unlike the CUDA-event time of one call on an idle GPU, this
    leaves out the wrapper's host work before the launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel_name in evt.key and evt.count:
            total = getattr(evt, "device_time_total",
                            getattr(evt, "cuda_time_total", 0.0))
            return total / evt.count / 1e3 if total else None
    return None


def mdtc_bound_ms(b, t, c, n_layers, k, n_stacks, pad_max, stream):
    """Least time on an H100 for one fused MDTC call: the larger of
    compulsory bytes over HBM bandwidth and fp32 operations over the
    fp32 peak.  Per frame and layer: 2KC (depthwise) + 4C^2 (two
    products) + 4C (three biases, residual); plus one add per stack
    output.  Bytes: x read, out written, folded weights read once, and
    the (L, B, pad_max, C) cache read and written when streaming."""
    frames = b * t
    flops = frames * (n_layers * (2 * k * c + 4 * c * c + 4 * c)
                      + n_stacks * c)
    nbytes = 4 * (2 * frames * c
                  + n_layers * (k * c + 2 * c * c + 3 * c))
    if stream:
        nbytes += 4 * 2 * n_layers * b * pad_max * c
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_close(name, got, want):
    import torch

    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=TOL, rtol=TOL)
    print(f"  {name}: max_abs_err {err:.3e} "
          f"(|ref| max {float(want.abs().max()):.3e}, bound {TOL} abs + "
          f"{TOL} rel) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with reference")
    return err


def synth_waves(rng):
    """8 keyword utterances (500 Hz tone in noise), then 8 of noise."""
    n = SECONDS * RATE
    t = np.arange(n) / RATE
    waves = rng.standard_normal((N_UTTS, n)) * 300.0
    waves[: N_UTTS // 2] += 4000.0 * np.sin(2 * np.pi * 500.0 * t)
    return np.clip(waves, -32768, 32767).astype(np.int16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import yaml

    from wekws_tpu_torch.eval import (
        compute_det,
        frr_at_fa_per_hour,
        load_label_and_score,
        write_score_file,
    )
    from wekws_tpu_torch.frontend import compute_fbank_np
    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops.fused_mdtc import (
        extract_mdtc_weights,
        fused_mdtc_forward,
        fused_mdtc_forward_plain,
        fused_mdtc_stream,
        fused_mdtc_stream_plain,
        init_stream_cache,
    )
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.runtime import BatchMaxPoolSpotter
    from wekws_tpu_torch.runtime.keyword_spotter import (
        load_serving_model,
        load_spotter_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    with phase("1 card"):
        card = card_line()
        print(card, flush=True)
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{kind}, {torch.cuda.device_count()} device(s)", flush=True)

    with phase("2 build kernels"):
        t0 = time.perf_counter()
        paths = cuda_build.build()
        for name in cuda_build.KERNEL_SOURCES:
            for line in cuda_build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        print(f"  built {len(paths)} librar(ies) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    model, _ = flagship_model(gen)
    mdtc = model.backbone
    *stacks, dilations = extract_mdtc_weights(mdtc)
    weights = tuple(w.to(dev) for w in stacks)
    k, stack_size = mdtc.kernel_size, mdtc.stack_size
    n_layers = len(dilations)
    pad_max = (k - 1) * max(dilations)
    errs = {"fused_mdtc_forward": 0.0, "fused_mdtc_stream": 0.0}

    def feats_like(b, t):
        return torch.randn((b, t, CHANNELS), generator=gen).to(dev)

    with phase("3 kernels vs plain (flagship width)"):
        for b, t in ((64, 198), (4, 1024)):
            x = feats_like(b, t)
            got = fused_mdtc_forward(x, *weights, dilations, k, stack_size)
            torch.cuda.synchronize()
            want = fused_mdtc_forward_plain(x, *weights, dilations, k,
                                            stack_size)
            errs["fused_mdtc_forward"] = max(
                errs["fused_mdtc_forward"],
                check_close(f"fused_mdtc_forward B={b} T={t}", got, want))
        b, t, step = 16, 200, 8
        x = feats_like(b, t)
        cache = init_stream_cache(n_layers, b, pad_max, CHANNELS, dev)
        plain_cache = cache.clone()
        outs, plain_outs = [], []
        for s in range(0, t, step):
            chunk = x[:, s:s + step].contiguous()
            y, cache = fused_mdtc_stream(chunk, cache, *weights, dilations,
                                         k, stack_size)
            outs.append(y)
            y, plain_cache = fused_mdtc_stream_plain(
                chunk, plain_cache, *weights, dilations, k, stack_size)
            plain_outs.append(y)
        torch.cuda.synchronize()
        streamed = torch.cat(outs, dim=1)
        full = fused_mdtc_forward(x, *weights, dilations, k, stack_size)
        errs["fused_mdtc_stream"] = max(
            check_close("fused_mdtc_stream vs one-shot forward (kernel)",
                        streamed, full),
            check_close("fused_mdtc_stream vs plain stream",
                        streamed, torch.cat(plain_outs, dim=1)),
            check_close("fused_mdtc_stream final cache vs plain",
                        cache, plain_cache),
        )

    launches = {}
    with phase("4 serving slice end to end"):
        work = os.path.join(cuda_build.BUILD_DIR, "chip_smoke")
        os.makedirs(work, exist_ok=True)
        waves = synth_waves(np.random.default_rng(SEED))
        configs = {"dataset_conf": DATASET_CONF}
        _, cfg, _, _, _ = load_spotter_config(configs)
        feats = np.stack([compute_fbank_np(w.astype(np.float32), cfg)
                          for w in waves])
        n_frames = feats.shape[1]
        mean = feats.mean(axis=(0, 1))
        istd = 1.0 / (feats.std(axis=(0, 1)) + 1e-6)
        model, model_conf = flagship_model(gen, (mean, istd))
        configs["model"] = model_conf
        ckpt = os.path.join(work, "flagship.pt")
        config_path = os.path.join(work, "config.yaml")
        torch.save(model.state_dict(), ckpt)
        with open(config_path, "w") as f:
            yaml.safe_dump(configs, f)
        served = load_serving_model(configs, ckpt, cfg.feat_dim, device=dev)
        n_params = sum(p.numel() for p in served.parameters())
        print(f"  flagship model: {n_params} parameters, features "
              f"{feats.shape}", flush=True)

        # (a) offline scoring through the whole-utterance kernel
        keys = [f"utt{i:02d}" for i in range(N_UTTS)]
        lengths = np.full((N_UTTS,), n_frames, np.int64)
        batch = {"keys": keys, "feats": feats, "lengths": lengths}
        fused_mdtc_forward.launches = 0
        forward = build_fused_forward(served, device=dev)
        offline = {}

        def forward_fn(b):
            probs = forward(b["feats"], b["lengths"])
            offline["probs"] = probs
            return probs.cpu().numpy(), b["lengths"]

        score_file = os.path.join(work, "score.txt")
        label_file = os.path.join(work, "labels.jsonl")
        write_score_file(forward_fn, [batch], [KEYWORD], score_file)
        torch.cuda.synchronize()
        launches["fused_mdtc_forward"] = fused_mdtc_forward.launches
        with open(label_file, "w") as f:
            for i, key in enumerate(keys):
                txt = KEYWORD if i < N_UTTS // 2 else "FILLER"
                f.write(json.dumps({"key": key, "txt": txt,
                                    "duration": float(SECONDS)}) + "\n")
        kw_table, filler_table, filler_s = load_label_and_score(
            KEYWORD, label_file, score_file)
        det = compute_det(kw_table, filler_table, filler_s)
        probs_a = offline["probs"]
        if tuple(probs_a.shape) != (N_UTTS, n_frames, 1):
            raise AssertionError(f"offline posteriors {tuple(probs_a.shape)}")
        if len(kw_table) != N_UTTS // 2 or not det:
            raise AssertionError("score file / DET lost utterances")
        print(f"  (a) offline: posteriors {tuple(probs_a.shape)}, DET "
              f"{len(det)} thresholds, FRR at 1 FA/h "
              f"{frr_at_fa_per_hour(det, 1.0):.3f} (random weights), "
              f"fused_mdtc_forward launches {launches['fused_mdtc_forward']}",
              flush=True)
        with torch.inference_mode():
            module_probs, _ = served(
                torch.as_tensor(feats, device=dev),
                lengths=torch.as_tensor(lengths, device=dev))
        check_close("(a) fused forward vs module forward", probs_a,
                    module_probs)

        # (b) batched streaming engine through the streaming kernel
        flat = probs_a.flatten().cpu().numpy()
        threshold = float(np.quantile(flat, 0.95))
        fused_mdtc_stream.launches = 0
        engine = BatchMaxPoolSpotter(
            ckpt, config_path, threshold, num_streams=N_UTTS,
            step_frames=8, keyword_names=[KEYWORD], use_fused=True,
            device=dev,
        )
        streamed = [[] for _ in range(N_UTTS)]
        step_fn = engine._step_fn

        def capture(feats_b, active, reset, cache):
            probs, new_cache = step_fn(feats_b, active, reset, cache)
            host = probs.cpu().numpy()
            for i in np.flatnonzero(active):
                streamed[i].append(host[i])
            return probs, new_cache

        engine._step_fn = capture
        events = []
        pcm = [w.astype("<i2").tobytes() for w in waves]
        for off in range(0, len(pcm[0]), 2 * CHUNK_SAMPLES):
            for i in range(N_UTTS):
                engine.accept_wave(i, pcm[i][off:off + 2 * CHUNK_SAMPLES])
            events += [r for r in engine.step().values() if r["state"]]
        events += [r for r in engine.flush().values() if r["state"]]
        torch.cuda.synchronize()
        launches["fused_mdtc_stream"] = fused_mdtc_stream.launches
        got = torch.as_tensor(np.stack(
            [np.concatenate(s, axis=0)[:n_frames] for s in streamed]))
        check_close("(b) streamed vs offline posteriors", got,
                    probs_a.cpu())
        stats = engine.stats
        print(f"  (b) streaming: {stats['dispatches']} steps of 8 frames x "
              f"{N_UTTS} streams, mean step {stats['dispatch_s'] * 1e3 / stats['dispatches']:.3f} ms "
              f"(host clock, first run), {len(events)} events at threshold "
              f"{threshold:.4f}, fused_mdtc_stream launches "
              f"{launches['fused_mdtc_stream']}", flush=True)
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"{name} never launched on its path")
        if not events:
            raise AssertionError("the streaming engine produced no events")

    record = []
    with phase("5 times"):
        shapes = {
            "fused_mdtc_forward": [(64, 198), (4, 1024), (N_UTTS, n_frames)],
            "fused_mdtc_stream": [(N_UTTS, 8)],
        }
        main_shape = {"fused_mdtc_forward": (N_UTTS, n_frames),
                      "fused_mdtc_stream": (N_UTTS, 8)}
        replaces = {"fused_mdtc_forward": "wekws_tpu/ops/fused_mdtc.py:37",
                    "fused_mdtc_stream": "wekws_tpu/ops/fused_mdtc.py:198"}
        for name, shape_list in shapes.items():
            stream = name == "fused_mdtc_stream"
            for b, t in shape_list:
                x = feats_like(b, t)
                if stream:
                    c0 = torch.randn((n_layers, b, pad_max, CHANNELS),
                                     generator=gen).to(dev)
                    kern = lambda: fused_mdtc_stream(  # noqa: E731
                        x, c0, *weights, dilations, k, stack_size)
                    plain = lambda: fused_mdtc_stream_plain(  # noqa: E731
                        x, c0, *weights, dilations, k, stack_size)
                else:
                    kern = lambda: fused_mdtc_forward(  # noqa: E731
                        x, *weights, dilations, k, stack_size)
                    plain = lambda: fused_mdtc_forward_plain(  # noqa: E731
                        x, *weights, dilations, k, stack_size)
                # plain, kernel, kernel, plain: report the second of each
                cuda_time_ms(plain)
                cuda_time_ms(kern)
                ms = cuda_time_ms(kern)
                plain_ms = cuda_time_ms(plain)
                bound, bound_by = mdtc_bound_ms(
                    b, t, CHANNELS, n_layers, k, mdtc.stack_num, pad_max,
                    stream)
                dev_ms = profiled_device_ms(kern, "fused_mdtc_kernel")
                dev_txt = ("not measured" if dev_ms is None
                           else f"{dev_ms:.4f} ms")
                print(f"  {name} B={b} T={t}: kernel {ms:.4f} ms per call "
                      f"(device time {dev_txt}), plain {plain_ms:.4f} ms, "
                      f"bound {bound:.5f} ms ({bound_by}) [{card}]",
                      flush=True)
                if (b, t) == main_shape[name]:
                    record.append({
                        "name": name, "route": "cuda",
                        "source": "wekws_tpu_torch/csrc/fused_mdtc.cu",
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name],
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": None,
                    })

    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
