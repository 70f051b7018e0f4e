#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (wekws_tpu_torch).

Drives the flagship MDTC max-pooling wake word (40-mel fbank, global
CMVN, linear preprocessing, MDTC 4 stacks x 4 blocks, kernel 5, 64
channels, linear head + sigmoid), the hey_snips DS-TCN wake word
(linear preprocessing to 64, 4 DS blocks, kernel 8) and the hi_xiaowen
FSMN-CTC model (80-mel fbank, context +-2, skip 3, 4 layers 250/128,
2599 tokens), each at full width with random weights from a seed, on
one CUDA device, in phases; any failure exits non-zero:

1. card name and power limit (nvidia-smi); a GPU is required;
2. build every CUDA kernel from ``wekws_tpu_torch/csrc`` and print
   what ``ptxas`` says of registers and spills (the kernels of F3, B2,
   B3 and B4 by name, at C = 32, 64, 128);
3. each serving kernel against its plain PyTorch version on the card,
   at flagship width: whole-utterance forward at B=64 x T=198 and
   B=4 x T=1024, streaming at B=16 in chunks of 8 over 200 frames
   (chained, against the one-shot forward); bound 1e-4 abs + 1e-4 rel
   (fp32, another summation order);
4. the serving slice end to end: 16 synthetic 2 s utterances ->
   fbank -> checkpoint saved and loaded through ``load_serving_model``
   -> (a) offline ``build_fused_forward`` -> score file -> DET, held
   against the module forward; (b) ``BatchMaxPoolSpotter(use_fused=
   True)`` fed 300 ms chunks, stepped and flushed, held against (a).
   Kernel launch counts are zeroed before each path and read after;
5. serving kernel and plain times (CUDA events around one call,
   warm-up, median of 30 calls; the kernel's device time alone from
   torch.profiler) beside the bound computed from this run's shapes;
6. the eight fused training passes (F1-F4, B1-B4) against their plain
   versions on identical inputs, at flagship width (C=64, K=5): the
   main path's B=512 x T=198 at dilations 1, 2, 4 and 8 (six to eight
   tiles per block of the persistent grid), B=64 x T=198 (one tile
   per block), a ragged B=5 x T=130 at dilations 1 and 8, B=7 x T=20
   (shorter than the halo of 32 frames; F3's, B2's and B3's tiles of the
   flattened frames span several utterances), and C=32 and C=128 once;
   each pass launched twice must agree bitwise (deterministic
   reductions).
   The whole fused block (forward, six batch statistics,
   twelve parameter gradients and dx) against the unfused module block
   by autograd on the card;
7. the training slice end to end at B=512 x 2 s: device fbank +
   CMVN from the batch + ``init_model(FLAGSHIP + fused_train)`` +
   ``Trainer``: step 0 held against the unfused Trainer (loss) and,
   with the unfused Trainer, against the unfused model in float64 (the
   gradients of each block and of each other tensor, against their own
   scale), 5 steps without augmentation (loss finite and
   decreasing), 2 steps with the flagship dither + spec_aug; every
   pass launched 17 x steps times; cv step, two checkpoints saved,
   averaged and loaded, and the trained model served through
   ``build_fused_forward``, held against the module forward;
8. training times: each pass per call (CUDA events, median of 30) at
   B=512 x T=198, its device time per call in a profiled train step
   (its kernel and its own block reduction; failing where a pass's
   kernel is missing from the profile), the plain version's time and
   the bound; F3 + B2 and B3 + B4 per block; the device time of the
   whole step and of the training kernels in it; the whole train step;
9. the three later kernels against their plain versions at full width:
   ``fused_ds_tcn`` at B=64 x T=198, B=4 x T=1024 and B=16 chained in
   chunks of 8 over 200 frames; ``fused_fsmn_layers`` at B=16 x T=66,
   B=4 x T=1024 and B=1 chained in chunks of 10 over 200 frames (each
   chain against the one-shot call and the plain chain, final cache
   too; 1e-4 abs + 1e-4 rel); ``fused_fbank`` at (512, 32000) M=40,
   (64, 32000) M=80, MFCC and magnitude/no-log against the three-matmul
   plain version; its in-kernel dither by the per-bin mean and standard
   deviation of the log-mel over 101,376 frames against torch.randn,
   same seed bitwise equal, another seed different;
10. path A, as phase 4 for the DS-TCN recipe: offline fused forward ->
    score file -> DET and ``BatchMaxPoolSpotter(use_fused=True)``,
    through ``fused_ds_tcn``;
11. path B: ``KeyWordSpotter`` with and without ``use_fused`` fed the
    same 2 s waves in 300 ms chunks (softmax posteriors and result
    dicts agree; one ``fused_fsmn_layers`` launch per chunk that carried
    frames), ``build_fused_forward(softmax=True)`` at B=16 against the
    module, and the detector firing on injected keyword posteriors;
12. path C: the phase-7 trainer with ``fused_frontend: True``: step-0
    features and loss against the unfused frontend, steps with the
    flagship's wave-mode dither + spec_aug, two steps with frame-mode
    (in-kernel) dither, a cv step; one ``fused_fbank`` launch per step;
13. times of the three kernels at their main shapes, of the path-C
    train step beside the unfused-frontend step, and of
    ``KeyWordSpotter.forward`` per 300 ms chunk.

The last lines are the card, the per-kernel JSON record (13 kernels)
and ``{"ok": true, "device": {...}}``.  Run from the repository root:
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
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12
TRAIN_B, TRAIN_SECONDS = 512, 2
TRAIN_DATASET_CONF = {  # __graft_entry__.DATASET_CONF, the flagship recipe
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0,
                   "dither_mode": "wave", "precision": "default"},
    "spec_aug": True,
    "spec_aug_conf": {"num_t_mask": 1, "num_f_mask": 1,
                      "max_t": 20, "max_f": 10},
}
TRAIN_STEPS_PLAIN, TRAIN_STEPS_AUG = 5, 2
# step-0 gradients of each block against float64, relative to the
# block's largest |grad|.  Exact BN's E[x^2] - E[x]^2 cancels in fp32,
# and the unfused fp32 route itself is off float64 by up to 4.6e-3 of a
# block's largest |grad| here (1.1e-2 on the CPU at B=8); a wrong
# kernel is off by the order of the gradient itself
GRAD64_TOL = 2e-2
TRAIN_PASSES = ("f1", "f2", "f3", "f4", "b1", "b2", "b3", "b4")
# the passes redesigned for the card (float4 elementwise steps; products
# in registers, on the tensor cores or none): phase 2 prints their
# registers and spills by name
REDESIGNED_KERNELS = ("f3_kernel", "b2_kernel", "b3_kernel", "b4_kernel")
KEYWORD = "HI"
DS_TCN_MODEL_CONF = {  # examples/hey_snips/conf/ds_tcn.yaml
    "input_dim": 40, "output_dim": 1, "hidden_dim": CHANNELS,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "tcn", "ds": True, "num_layers": 4,
                 "kernel_size": 8, "dropout": 0.1},
}
FSMN_VOCAB = 2599
FSMN_MODEL_CONF = {  # examples/hi_xiaowen/conf/fsmn_ctc.yaml
    "input_dim": 400, "output_dim": FSMN_VOCAB, "hidden_dim": 128,
    "preprocessing": {"type": "none"},
    "backbone": {"type": "fsmn", "input_affine_dim": 140, "num_layers": 4,
                 "linear_dim": 250, "proj_dim": 128, "left_order": 10,
                 "right_order": 2, "left_stride": 1, "right_stride": 1,
                 "output_affine_dim": 140},
    "classifier": {"type": "identity", "dropout": 0.1},
    "activation": {"type": "identity"},
}
FSMN_DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0},
    "context_expansion": True,
    "context_expansion_conf": {"left": 2, "right": 2},
    "frame_skip": 3,
}
CTC_KEYWORD, CTC_KEYWORD_TOKENS = "hixiaowen", (10, 20, 30)
# log-mel (magnitude ~1e1) and MFCC against the three-matmul plain
# version: fp32 sums over 400 and 257 terms in another order, then a log
FBANK_ATOL, FBANK_RTOL = 1e-3, 1e-4
# in-kernel dither against torch.randn, per mel bin over 101,376 frames
# of independent noise: the standard error of a bin's mean is about
# 0.003 and of its standard deviation about 0.3% (more in the low bins,
# whose few DFT bins give the log a heavy tail)
DITHER_MEAN_TOL, DITHER_STD_RTOL = 0.02, 0.03
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


def seeded_model(base_conf, generator, cmvn=None):
    """KWSModel of ``base_conf`` with seeded weights and BN statistics
    nudged so that folding is not the identity."""
    import torch

    from wekws_tpu_torch.models import init_model

    conf = dict(base_conf)
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

    for _ in range(2):  # a trace now and then comes back without it
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for evt in prof.key_averages():  # every entry of that name
            if kernel_name in evt.key and evt.count:
                dev = getattr(evt, "device_time_total",
                              getattr(evt, "cuda_time_total", 0.0))
                if dev:
                    total += dev
                    count += evt.count
        if count:
            return total / count / 1e3
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


def check_close(name, got, want, quiet=False, atol=TOL, rtol=TOL):
    import torch

    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
    if not quiet or not ok:
        print(f"  {name}: max_abs_err {err:.3e} "
              f"(|ref| max {float(want.abs().max()):.3e}, bound {atol} abs "
              f"+ {rtol} rel) {'ok' if ok else 'MISMATCH'}", flush=True)
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


def serving_slice(tag, base_conf, gen, dev, work, waves, offline_kernel,
                  stream_kernel, launches):
    """A max-pooling wake-word model of ``base_conf`` served end to end:
    16 synthetic 2 s utterances -> fbank -> checkpoint saved and loaded
    through ``load_serving_model`` -> (a) offline ``build_fused_forward``
    -> score file -> DET, held against the module forward; (b)
    ``BatchMaxPoolSpotter(use_fused=True)`` fed 300 ms chunks, stepped
    and flushed, held against (a).  The launch count of each path's
    kernel wrapper is zeroed before the path and read after it into
    ``launches[f"{tag}_offline"]`` / ``launches[f"{tag}_stream"]``.
    Returns the number of frames per utterance."""
    import torch
    import yaml

    from wekws_tpu_torch.eval import (
        compute_det,
        frr_at_fa_per_hour,
        load_label_and_score,
        write_score_file,
    )
    from wekws_tpu_torch.frontend import compute_fbank_np
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.runtime import BatchMaxPoolSpotter
    from wekws_tpu_torch.runtime.keyword_spotter import (
        load_serving_model,
        load_spotter_config,
    )

    configs = {"dataset_conf": DATASET_CONF}
    _, cfg, _, _, _ = load_spotter_config(configs)
    feats = np.stack([compute_fbank_np(w.astype(np.float32), cfg)
                      for w in waves])
    n_frames = feats.shape[1]
    mean = feats.mean(axis=(0, 1))
    istd = 1.0 / (feats.std(axis=(0, 1)) + 1e-6)
    model, model_conf = seeded_model(base_conf, gen, (mean, istd))
    configs["model"] = model_conf
    ckpt = os.path.join(work, f"{tag}.pt")
    config_path = os.path.join(work, f"{tag}.yaml")
    torch.save(model.state_dict(), ckpt)
    with open(config_path, "w") as f:
        yaml.safe_dump(configs, f)
    served = load_serving_model(configs, ckpt, cfg.feat_dim, device=dev)
    n_params = sum(p.numel() for p in served.parameters())
    print(f"  {tag} model: {n_params} parameters, features "
          f"{feats.shape}", flush=True)

    # (a) offline scoring through the whole-utterance kernel
    keys = [f"utt{i:02d}" for i in range(N_UTTS)]
    lengths = np.full((N_UTTS,), n_frames, np.int64)
    batch = {"keys": keys, "feats": feats, "lengths": lengths}
    offline_kernel.launches = 0
    forward = build_fused_forward(served, device=dev)
    offline = {}

    def forward_fn(b):
        probs = forward(b["feats"], b["lengths"])
        offline["probs"] = probs
        return probs.cpu().numpy(), b["lengths"]

    score_file = os.path.join(work, f"{tag}_score.txt")
    label_file = os.path.join(work, f"{tag}_labels.jsonl")
    write_score_file(forward_fn, [batch], [KEYWORD], score_file)
    torch.cuda.synchronize()
    launches[f"{tag}_offline"] = offline_kernel.launches
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
          f"{offline_kernel.__name__} launches "
          f"{launches[f'{tag}_offline']}", flush=True)
    with torch.inference_mode():
        module_probs, _ = served(
            torch.as_tensor(feats, device=dev),
            lengths=torch.as_tensor(lengths, device=dev))
    check_close("(a) fused forward vs module forward", probs_a,
                module_probs)

    # (b) batched streaming engine through the streaming kernel
    flat = probs_a.flatten().cpu().numpy()
    threshold = float(np.quantile(flat, 0.95))
    stream_kernel.launches = 0
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
    launches[f"{tag}_stream"] = stream_kernel.launches
    got = torch.as_tensor(np.stack(
        [np.concatenate(s, axis=0)[:n_frames] for s in streamed]))
    check_close("(b) streamed vs offline posteriors", got,
                probs_a.cpu())
    stats = engine.stats
    print(f"  (b) streaming: {stats['dispatches']} steps of 8 frames x "
          f"{N_UTTS} streams, mean step {stats['dispatch_s'] * 1e3 / stats['dispatches']:.3f} ms "
          f"(host clock, first run), {len(events)} events at threshold "
          f"{threshold:.4f}, {stream_kernel.__name__} launches "
          f"{launches[f'{tag}_stream']}", flush=True)
    for path in ("offline", "stream"):
        if launches[f"{tag}_{path}"] < 1:
            raise AssertionError(f"{tag}: no kernel launch on its {path} "
                                 f"path")
    if not events:
        raise AssertionError("the streaming engine produced no events")
    return n_frames


def train_pass_bound_ms(name, b, t, c, k):
    """Least time on an H100 for one training pass: the larger of the
    compulsory bytes over HBM bandwidth (each (B, T, C) input read once,
    each output written once, weights once) and its operations over the
    peak of the unit the kernel uses (an FMA counts 2).  Per frame and
    channel: the depthwise conv 2K, each C x C product 2C, the
    elementwise BN, ReLU and exact-BN backward terms as counted below,
    all at the fp32 peak outside the tensor cores, except B3's four
    products: they run on the tensor cores in TF32, three passes each,
    so at a third of the TF32 peak (0.0201 ms at the main shape; as
    fp32 FMAs they would take 0.0496 ms).  F3's and B2's products are
    fp32 FMAs.  B3 reads dy, w, x, r and writes ds0; B4 reads dy, w, x,
    ds0, writes dx and has no product."""
    n = b * t
    act = 4 * n * c  # one (B, T, C) float32 tensor
    w = 4 * c * c
    per_frame = {  # fp32 operations per frame outside the tensor cores
        "f1": c * (2 * k + 3),
        "f2": c * (2 * k + 2) + 2 * c * c + 4 * c,
        "f3": c * (2 * k + 2) + 4 * c * c + 11 * c,
        "f4": 4 * c,
        "b1": 10 * c,
        "b2": 4 * c * c + 20 * c,
        "b3": c * (2 * k + 30),
        "b4": c * (6 * k + 30),
    }[name]
    tensor_per_frame = 8 * c * c if name == "b3" else 0
    nbytes = {
        "f1": act, "f2": act + w, "f3": 3 * act + 2 * w, "f4": 3 * act,
        "b1": 3 * act, "b2": 4 * act + 2 * w, "b3": 5 * act + 3 * w,
        "b4": 5 * act + 4 * (2 * k * c + c),
    }[name]
    t_ops = (n * per_frame / PEAK_FP32_FLOPS
             + n * tensor_per_frame / (PEAK_TF32_FLOPS / 3)) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase6_train_kernels(dev, gen):
    """Every training pass against its plain version, plus the whole
    fused block against the unfused module block.  Returns the largest
    error of each pass, and the passes' inputs at the main shape and
    dilation 8 for phase 8's times."""
    import torch

    from wekws_tpu_torch.models.mdtc import TCNBlock
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        SUM_TOL,
        compare_pass,
        compare_sums,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    errs = {name: 0.0 for name in TRAIN_PASSES}
    k = 5
    # the main path's shape at each of the flagship's dilations, where
    # each block of the persistent grid carries its sums across six to
    # eight tiles; one tile per block; a ragged batch; an utterance
    # shorter than the halo (K-1) d = 32; C=32; C=128
    cases = [(TRAIN_B, 198, 64, d) for d in (1, 2, 4, 8)] + [
        (64, 198, 64, 1), (64, 198, 64, 8), (5, 130, 64, 1),
        (5, 130, 64, 8), (7, 20, 64, 8), (64, 198, 32, 8),
        (64, 198, 128, 8)]
    main_calls = None
    for b, t, c, d in cases:
        p, x, dy = seeded_block_inputs(gen, b, t, c, k, dev)
        calls = trace_pass_inputs(x, p, dy, d)
        for name, args in calls.items():
            got = PASSES[name](*args)
            again = PASSES[name](*args)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], compare_pass(
                f"{name} B={b} T={t} C={c} d={d}", got,
                PASSES[name].plain(*args)))
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
        if (b, c, d) == (TRAIN_B, 64, 8):
            main_calls = calls
        print(f"  passes B={b} T={t} C={c} d={d}: "
              + ", ".join(f"{n} {errs[n]:.2e}" for n in TRAIN_PASSES)
              + " (running max abs err; bitwise reproducible)", flush=True)

    # the whole block: fused Function vs autograd of the unfused modules
    for b, t, d in ((64, 198, 1), (5, 130, 8)):
        blocks = [TCNBlock(64, 64, k, d, fused_train=fused).to(dev).train()
                  for fused in (True, False)]
        with torch.no_grad():
            for prm in blocks[0].parameters():
                prm.copy_(torch.randn(prm.shape, generator=gen).to(dev)
                          * 0.3)
        blocks[1].load_state_dict(blocks[0].state_dict())
        x = torch.randn((b, t, 64), generator=gen).to(dev)
        dy = torch.randn((b, t, 64), generator=gen).to(dev)
        outs = []
        for blk in blocks:
            xi = x.clone().requires_grad_()
            y, _ = blk(xi, None)
            (y * dy).sum().backward()
            outs.append((y.detach(), xi.grad, blk))
        (yf, dxf, bf), (yu, dxu, bu) = outs
        check_close(f"block B={b} T={t} d={d} y", yf, yu)
        check_close(f"block B={b} T={t} d={d} dx", dxf, dxu)
        for (name, bufa), bufb in zip(bf.named_buffers(), bu.buffers()):
            if "running" in name:  # the six batch statistics, folded in
                check_close(f"block {name}", bufa, bufb)
        worst = compare_sums("block grads",
                             [prm.grad for prm in bf.parameters()],
                             [prm.grad for prm in bu.parameters()])
        print(f"  fused block B={b} T={t} d={d} vs unfused autograd: y, "
              f"dx and running statistics within {TOL} abs + {TOL} rel; "
              f"12 parameter gradients max err {worst:.2e} (bound "
              f"{SUM_TOL} x the largest |grad|)", flush=True)
    return errs, main_calls


def float64_grads(conf, state_dict, feats, feat_lengths, batch):
    """Gradients of the unfused model in float64 on the same features
    and loss as a train step: the reference of both fp32 routes."""
    import torch

    from wekws_tpu_torch.losses import criterion
    from wekws_tpu_torch.models import init_model

    model = init_model(conf)
    model.load_state_dict(state_dict)
    model = model.to(feats.device, torch.float64).train()
    logits, _ = model(feats.to(torch.float64), lengths=feat_lengths)
    loss, _ = criterion(
        "max_pooling", logits,
        torch.as_tensor(batch["target"], device=feats.device),
        feat_lengths,
        torch.as_tensor(batch["target_lengths"], device=feats.device), 5)
    loss.backward()
    return model


def grad_groups(model):
    """{name: parameters}: one group per TCNBlock, whose twelve
    gradients share one scale as a pass's sums do, and one group for
    each other parameter tensor."""
    from wekws_tpu_torch.models.mdtc import TCNBlock

    groups, grouped = {}, set()
    for name, mod in model.named_modules():
        if isinstance(mod, TCNBlock):
            groups[name] = list(mod.parameters())
            grouped.update(id(p) for p in groups[name])
    for name, prm in model.named_parameters():
        if id(prm) not in grouped:
            groups[name] = [prm]
    return groups


def train_batch(rng):
    """TRAIN_B utterances of TRAIN_SECONDS: keyword rows carry a 500 Hz
    tone in noise, fillers noise (as __graft_entry__'s dry run)."""
    n = TRAIN_SECONDS * RATE
    t = np.arange(n) / RATE
    waves = (rng.standard_normal((TRAIN_B, n)) * 300).astype(np.float32)
    waves[::2] += (4000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    waves = np.clip(waves, -32768, 32767)
    return {"waves": waves,
            "wave_lengths": np.full((TRAIN_B,), n, np.int32),
            "target": (np.arange(TRAIN_B) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((TRAIN_B,), np.int32)}


def phase7_train_slice(dev, work, launches):
    """Train -> checkpoint -> serve at B=512 x 2 s; returns what the
    later phases reuse (trainer, state, batch, model config)."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        compare_sums,
        reset_launches,
    )
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.train import (
        Trainer,
        average_checkpoints,
        load_checkpoint,
        save_checkpoint,
    )

    plain_conf = dict(TRAIN_DATASET_CONF, spec_aug=False)
    plain_conf["fbank_conf"] = dict(TRAIN_DATASET_CONF["fbank_conf"],
                                    dither=0.0)
    cvp = DeviceFeaturePipeline.from_conf(TRAIN_DATASET_CONF, training=False)
    batch = train_batch(np.random.default_rng(SEED))
    waves = torch.as_tensor(batch["waves"], device=dev)
    lengths = torch.as_tensor(batch["wave_lengths"], device=dev)
    with torch.no_grad():
        feats, feat_lengths = cvp(waves, lengths)
    mean = feats.mean(dim=(0, 1)).cpu().numpy()
    istd = (1.0 / (feats.std(dim=(0, 1)) + 1e-6)).cpu().numpy()
    conf = dict(FLAGSHIP_MODEL_CONF,
                cmvn={"mean": mean.tolist(), "istd": istd.tolist(),
                      "norm_var": True})
    conf["backbone"] = dict(conf["backbone"], fused_train=True)
    unfused_conf = dict(conf, backbone=dict(conf["backbone"],
                                            fused_train=False))

    def trainer_for(model_conf, dataset_conf, state_dict=None):
        model = init_model(model_conf, torch.Generator().manual_seed(SEED))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            # the four stacks' ReLU outputs are summed (|y| up to ~50 at
            # init), so a head drawn at N(0, 1/64) saturates the sigmoid,
            # where the clamped max-pooling loss has no gradient: start
            # the head small
            with torch.no_grad():
                model.classifier.linear.weight.mul_(0.01)
        return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                       cvp, "max_pooling", grad_clip=5.0, min_duration=5,
                       device=dev)

    trainer = trainer_for(conf, plain_conf)
    state = trainer.init_state()
    twin = trainer_for(unfused_conf, plain_conf,
                       trainer.model.state_dict())
    twin_state = twin.init_state()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"  flagship + fused_train: {n_params} parameters, batch "
          f"{TRAIN_B} x {TRAIN_SECONDS} s, features {tuple(feats.shape)}",
          flush=True)

    reset_launches()
    losses = []
    for step in range(TRAIN_STEPS_PLAIN):
        if step == 0:
            want_loss, _ = twin.loss_and_grads(twin_state, batch, SEED)
        state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
        losses.append(float(metrics["loss"]))
        if step == 0:
            # p.grad still holds step 0's gradients after the update
            err = abs(losses[0] - float(want_loss))
            if err > 1e-5 * abs(float(want_loss)):
                raise AssertionError(f"step-0 loss {losses[0]} vs unfused "
                                     f"{float(want_loss)}")
            # both fp32 routes against float64, each block's gradients
            # against that block's own largest |grad| (a small absolute
            # floor for a group near zero), so that a wrong block cannot
            # hide under the head's gradients
            with torch.no_grad():
                f0, l0 = twin.pipeline(waves, lengths)
            ref = grad_groups(float64_grads(
                unfused_conf, twin.model.state_dict(), f0, l0, batch))
            share = {}
            for route, tr in (("fused", trainer), ("unfused", twin)):
                share[route] = 0.0
                for gname, got in grad_groups(tr.model).items():
                    wants = [p.grad.float() for p in ref[gname]]
                    gerr = compare_sums(
                        f"step-0 grads {route} {gname} vs float64",
                        [p.grad for p in got], wants, floor=1e-6,
                        tol=GRAD64_TOL)
                    scale = max([float(g.abs().max()) for g in wants]
                                + [1e-6])
                    share[route] = max(share[route], gerr / scale)
            print(f"  step 0 vs the unfused Trainer: loss {losses[0]:.6f} "
                  f"(diff {err:.2e}); gradients vs float64, 17 blocks and "
                  f"4 other tensors each within {GRAD64_TOL} x its own "
                  f"largest |grad|: worst fused {share['fused']:.2e}, "
                  f"unfused {share['unfused']:.2e} of that", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and decreasing: {losses}")
    # the flagship recipe's augmentation from here on
    trainer.pipeline = DeviceFeaturePipeline.from_conf(TRAIN_DATASET_CONF)
    aug_losses = []
    for _ in range(TRAIN_STEPS_AUG):
        state, metrics = trainer.train_step(state, batch, SEED, 1e-3)
        aug_losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    steps = TRAIN_STEPS_PLAIN + TRAIN_STEPS_AUG
    n_blocks = 1 + 4 * 4
    for name in TRAIN_PASSES:
        launches[f"fused_train_{name}"] = PASSES[name].launches
        if PASSES[name].launches != n_blocks * steps:
            raise AssertionError(
                f"pass {name} launched {PASSES[name].launches} times, "
                f"expected {n_blocks} x {steps}")
    if not all(np.isfinite(aug_losses)):
        raise AssertionError(f"augmented steps: {aug_losses}")
    print(f"  losses, no augmentation: {[round(v, 5) for v in losses]}; "
          f"with dither + spec_aug: {[round(v, 5) for v in aug_losses]}; "
          f"each pass launched {n_blocks} x {steps} = {n_blocks * steps} "
          f"times", flush=True)

    cv = trainer.cv_step(state, batch)
    cv_loss = float(cv["loss_sum"]) / max(float(cv["count"]), 1.0)
    if not np.isfinite(cv_loss) or int(cv["count"]) != TRAIN_B:
        raise AssertionError(f"cv step: {cv}")
    for epoch in range(2):
        save_checkpoint(os.path.join(work, f"{epoch}.pt"),
                        state.model.state_dict(),
                        {"epoch": epoch, "lr": 1e-3,
                         "cv_loss": cv_loss + epoch})
        if epoch == 0:
            state, _ = trainer.train_step(state, batch, SEED, 1e-3)
    picked = average_checkpoints(work, os.path.join(work, "avg.pt"), 2)
    served = init_model(conf)
    served.load_state_dict(load_checkpoint(os.path.join(work, "avg.pt")))
    served = served.to(dev).eval()
    forward = build_fused_forward(served, device=dev)
    sub = slice(0, N_UTTS)
    probs = forward(feats[sub], feat_lengths[sub])
    with torch.inference_mode():
        module_probs, _ = served(feats[sub], lengths=feat_lengths[sub])
    check_close("trained + averaged model: fused serving vs module forward",
                probs, module_probs)
    print(f"  cv loss {cv_loss:.5f} over {int(cv['count'])} utterances; "
          f"averaged {len(picked)} checkpoints and served {N_UTTS} "
          f"utterances through build_fused_forward", flush=True)
    return trainer, state, batch, conf


def phase8_train_times(trainer, state, batch, card, launches, errs,
                       calls):
    """Per-pass and whole-step times at B=512 x T=198; ``calls`` holds
    each pass's inputs at that shape (dilation 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASS_IDS,
        PASSES,
        kernel_name,
    )

    # the whole train step (host clock around synchronised steps)
    for _ in range(2):
        trainer.train_step(state, batch, SEED, 1e-3)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(state, batch, SEED, 1e-3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    audio = TRAIN_B * TRAIN_SECONDS
    print(f"  train step B={TRAIN_B} x {TRAIN_SECONDS} s (fused_train, "
          f"dither + spec_aug): {step_ms:.3f} ms, "
          f"{audio / step_ms * 1e3:.1f} audio-s/s [{card}]", flush=True)

    # device time of each pass inside a profiled train step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch, SEED, 1e-3)
        torch.cuda.synchronize()
    kernels = {}
    on_device = {}  # device entries (kernels, copies, fills): total us
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0.0))
        if evt.count and total and str(getattr(evt, "device_type", "")) \
                .endswith("CUDA"):
            on_device[evt.key] = total
        kernels[evt.key] = (total, evt.count)
    busy = sum(on_device.values())

    def dev_ms(fragment):
        for key, (total, count) in kernels.items():
            if fragment in key and count:
                return total / count / 1e3
        return None

    if any("dx_kernel" in key for key in kernels):
        raise AssertionError("a dx_kernel ran in the profiled step: B4 is "
                             "one kernel and its reduction")
    pass_kernel = {name: kernel_name(name, 64) for name in TRAIN_PASSES}
    ours = list(pass_kernel.values()) + ["reduce_kernel"]
    kernel_total = sum(t for key, (t, _) in kernels.items()
                       if any(f in key for f in ours)) / 1e3
    print(f"  profiled step: {busy / 1e3:.3f} ms of device time in all, "
          f"{kernel_total:.3f} ms in the training kernels; the device is "
          f"idle for {max(0.0, 1 - busy / 1e3 / step_ms):.1%} of the "
          f"unprofiled {step_ms:.3f} ms step [{card}]", flush=True)
    rest = sorted(((t, key) for key, t in on_device.items()
                   if not any(f in key for f in ours)), reverse=True)
    print("  the rest of the device time, largest first: "
          + "; ".join(f"{key[:70]} {t / 1e3:.3f} ms" for t, key in rest[:6])
          + f" [{card}]", flush=True)

    record = []
    device_ms = {}
    b, t, c, k, d = TRAIN_B, 198, 64, 5, 8
    for name in TRAIN_PASSES:
        args = calls[name]
        kern = lambda: PASSES[name](*args)  # noqa: E731
        plain = lambda: PASSES[name].plain(*args)  # noqa: E731
        cuda_time_ms(plain)
        cuda_time_ms(kern)
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain)
        torch.cuda.synchronize()
        host = []
        for _ in range(30):  # the wrapper's host work: enqueue, no sync
            t0 = time.perf_counter()
            kern()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms = float(np.median(host))
        bound, bound_by = train_pass_bound_ms(name, b, t, c, k)
        main = dev_ms(pass_kernel[name])
        reduce_ms = None
        if name != "f4":  # its own block reduction
            reduce_ms = dev_ms(f"reduce_kernel<{PASS_IDS[name]}>")
        if main is None or (name != "f4" and reduce_ms is None):
            raise AssertionError(
                f"pass {name}: no kernel {pass_kernel[name]} (or its "
                f"reduction) in the profiled train step")
        device_ms[name] = main + (reduce_ms or 0.0)
        dev_txt = f"{device_ms[name]:.4f} ms"
        if reduce_ms is not None:
            dev_txt += f", of it {reduce_ms:.4f} ms its reduction"
        print(f"  fused_train_{name} B={b} T={t} d={d}: kernel {ms:.4f} ms "
              f"per call (device time per call in the train step "
              f"{dev_txt}; host enqueue {host_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms "
              f"({bound_by}), {launches[f'fused_train_{name}']} launches on "
              f"the main path (17 per step); library: none (no PyTorch "
              f"call computes "
              f"this pass) [{card}]", flush=True)
        record.append({
            "name": f"fused_train_{name}", "route": "cuda",
            "source": "wekws_tpu_torch/csrc/fused_mdtc_train.cu",
            "replaces": TRAIN_REPLACES[name],
            "launches": launches[f"fused_train_{name}"],
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,
        })
    print(f"  per block, with their reductions: F3 + B2 "
          f"{device_ms['f3'] + device_ms['b2']:.4f} ms, B3 + B4 "
          f"{device_ms['b3'] + device_ms['b4']:.4f} ms of device time; all "
          f"eight passes {sum(device_ms.values()):.4f} ms [{card}]",
          flush=True)
    return record, step_ms


def tcn_bound_ms(b, t, c, n_layers, k, pad_max):
    """Least time on an H100 for one fused DS-TCN call.  Per frame and
    layer: 2KC (depthwise) + 2C^2 (the product) + 5C (two biases, two
    ReLUs, residual).  Bytes: x read, out written, folded weights once,
    the (L, B, pad_max, C) cache read and written."""
    flops = b * t * n_layers * (2 * k * c + 2 * c * c + 5 * c)
    nbytes = 4 * (2 * b * t * c + n_layers * (k * c + c * c + 2 * c)
                  + 2 * n_layers * b * pad_max * c)
    return roofline_ms(flops, nbytes)


def fsmn_bound_ms(b, t, ld, pd, n_layers, lorder, rorder, pad):
    """Least time on an H100 for one fused FSMN layer-chain call.  Per
    frame and layer: 4 LD PD (two products) + 2 (lorder + rorder) PD + PD
    (taps, identity) + 2 LD (bias, ReLU).  Bytes: x, out, the weights
    once, the (L, B, P, PD) cache read and written."""
    flops = b * t * n_layers * (4 * ld * pd + 2 * (lorder + rorder) * pd
                                + pd + 2 * ld)
    nbytes = 4 * (2 * b * t * ld
                  + n_layers * (2 * ld * pd + (lorder + max(rorder, 1)) * pd
                                + ld)
                  + 2 * n_layers * b * pad * pd)
    return roofline_ms(flops, nbytes)


def fbank_bound_ms(b, s, frame_length, frame_shift, nbin, n_mel, n_out):
    """Least time on an H100 for one fused fbank call: per frame the two
    DFT products 2 x FL x 2 nbin, power 3 nbin, mel 2 nbin M, log M and
    for MFCC the DCT 2 M C.  Bytes: the wave read once, the features
    written once, the operators once (no frames buffer)."""
    rows = b * (1 + (s - frame_length) // frame_shift)
    dct = 2 * n_mel * n_out if n_out != n_mel else 0
    flops = rows * (4 * frame_length * nbin + 3 * nbin + 2 * nbin * n_mel
                    + n_mel + dct)
    nbytes = 4 * (b * s + rows * n_out + 2 * frame_length * nbin
                  + nbin * n_mel + dct // 2)
    return roofline_ms(flops, nbytes)


def roofline_ms(flops, nbytes):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def chained(step, x, cache, chunk):
    """``step(x_chunk, cache) -> (y, cache)`` over time chunks."""
    import torch

    outs = []
    for s in range(0, x.shape[1], chunk):
        y, cache = step(x[:, s:s + chunk].contiguous(), cache)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


def phase9_new_kernels(dev, gen, batch):
    """The three later kernels against their plain versions at full
    width.  Returns the largest error per kernel and what phase 13
    times: weights and the fbank extractors."""
    import torch

    from wekws_tpu_torch.frontend.features import FeatureExtractor
    from wekws_tpu_torch.frontend.kaldi import FrontendConfig
    from wekws_tpu_torch.ops.fused_fsmn import (
        extract_fsmn_weights,
        fused_fsmn_layers,
        fused_fsmn_layers_plain,
        init_fsmn_cache,
    )
    from wekws_tpu_torch.ops.fused_tcn import (
        extract_ds_tcn_weights,
        fused_ds_tcn,
        fused_ds_tcn_plain,
        init_tcn_cache,
    )

    errs = {"fused_ds_tcn": 0.0, "fused_fsmn_layers": 0.0,
            "fused_fbank": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def hold(kernel, name, pairs):
        for what, got, want in pairs:
            errs[kernel] = max(errs[kernel],
                               check_close(f"{name} {what}", got, want))

    # ---- fused_ds_tcn at the hey_snips width
    tcn = seeded_model(DS_TCN_MODEL_CONF, gen)[0].backbone
    *stacks, dil = extract_ds_tcn_weights(tcn)
    tw = tuple(w.to(dev) for w in stacks)
    k, c, n_layers = tcn.kernel_size, tcn.channel, len(dil)
    pad_max = (k - 1) * max(dil)
    for b, t in ((64, 198), (4, 1024)):
        x, cache = randn(b, t, c), randn(n_layers, b, pad_max, c)
        got = fused_ds_tcn(x, cache, *tw, dil, k)
        torch.cuda.synchronize()
        want = fused_ds_tcn_plain(x, cache, *tw, dil, k)
        hold("fused_ds_tcn", f"fused_ds_tcn B={b} T={t}",
             (("output", got[0], want[0]), ("new cache", got[1], want[1])))
    x = randn(16, 200, c)
    zero = init_tcn_cache(n_layers, 16, pad_max, c, dev)
    got = chained(lambda xc, cc: fused_ds_tcn(xc, cc, *tw, dil, k), x, zero,
                  8)
    want = chained(lambda xc, cc: fused_ds_tcn_plain(xc, cc, *tw, dil, k), x,
                   zero, 8)
    once = fused_ds_tcn(x, zero, *tw, dil, k)
    torch.cuda.synchronize()
    hold("fused_ds_tcn", "fused_ds_tcn B=16, 25 chunks of 8",
         (("vs one-shot (kernel)", got[0], once[0]),
          ("final cache vs one-shot", got[1], once[1]),
          ("vs plain chain", got[0], want[0]),
          ("final cache vs plain", got[1], want[1])))

    # ---- fused_fsmn_layers at the hi_xiaowen width
    fsmn = seeded_model(FSMN_MODEL_CONF, gen)[0].backbone
    fw = tuple(w.to(dev) for w in extract_fsmn_weights(fsmn)[4:9])
    orders = (fsmn.lorder, fsmn.rorder, fsmn.lstride, fsmn.rstride)
    ld, pd, pad = fsmn.linear_dim, fsmn.proj_dim, fsmn.layer_padding
    n_fsmn = fsmn.fsmn_layers
    for b, t in ((16, 66), (4, 1024)):
        # the chain's input is a ReLU output: non-negative
        x, cache = randn(b, t, ld).relu(), randn(n_fsmn, b, pad, pd)
        got = fused_fsmn_layers(x, cache, *fw, *orders)
        torch.cuda.synchronize()
        want = fused_fsmn_layers_plain(x, cache, *fw, *orders)
        hold("fused_fsmn_layers", f"fused_fsmn_layers B={b} T={t}",
             (("output", got[0], want[0]), ("new cache", got[1], want[1])))
    x = randn(1, 200, ld).relu()
    zero = init_fsmn_cache(n_fsmn, 1, pad, pd, dev)
    got = chained(lambda xc, cc: fused_fsmn_layers(xc, cc, *fw, *orders), x,
                  zero, 10)
    want = chained(
        lambda xc, cc: fused_fsmn_layers_plain(xc, cc, *fw, *orders), x,
        zero, 10)
    once = fused_fsmn_layers(x, zero, *fw, *orders)
    torch.cuda.synchronize()
    hold("fused_fsmn_layers", "fused_fsmn_layers B=1, 20 chunks of 10 < P",
         (("vs one-shot (kernel)", got[0], once[0]),
          ("final cache vs one-shot", got[1], once[1]),
          ("vs plain chain", got[0], want[0]),
          ("final cache vs plain", got[1], want[1])))

    # ---- fused_fbank against the unfused three-matmul extractor
    waves = torch.as_tensor(batch["waves"], device=dev)
    cases = (
        ("(512, 32000) fbank M=40", {"num_mel_bins": 40}, TRAIN_B),
        ("(64, 32000) fbank M=80", {"num_mel_bins": 80}, 64),
        ("(64, 32000) MFCC 13 of 40",
         {"feature_type": "mfcc", "num_mel_bins": 40, "num_ceps": 13}, 64),
        ("(64, 32000) magnitude, no log",
         {"num_mel_bins": 40, "use_power": False, "use_log_fbank": False},
         64),
    )
    extractors = {}
    for name, kw, b in cases:
        cfg = FrontendConfig(dither=1.0, dither_mode="frame", **kw)
        fused = FeatureExtractor(cfg, use_fused=True)
        plain = FeatureExtractor(cfg)
        got, _ = fused(waves[:b])
        torch.cuda.synchronize()
        want, _ = plain(waves[:b])
        if cfg.use_log_fbank:
            atol, rtol = FBANK_ATOL, FBANK_RTOL
        else:  # energies up to ~1e6: relative to the largest
            atol, rtol = 1e-4 * float(want.abs().max()), 1e-4
        err = check_close(f"fused_fbank {name}", got, want, atol=atol,
                          rtol=rtol)
        if cfg.use_log_fbank:
            errs["fused_fbank"] = max(errs["fused_fbank"], err)
        extractors[name] = (fused, plain)

    # in-kernel dither against torch.randn: distributions, not bits
    fused, plain = extractors["(512, 32000) fbank M=40"]
    gd = torch.Generator(device=dev)
    for what, w in (("zero waves", torch.zeros_like(waves)),
                    ("synthetic waves", waves)):
        outs = []
        for seed in (1, 1, 2):
            gd.manual_seed(seed)
            outs.append(fused(w, generator=gd)[0])
        gd.manual_seed(1)
        ref = plain(w, generator=gd)[0]
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]) or torch.equal(outs[0], outs[2]):
            raise AssertionError(f"dither on {what}: the same seed must give "
                                 f"the same bits, another seed others")
        if not torch.isfinite(outs[0]).all():
            raise AssertionError(f"dither on {what}: non-finite features")
        n = outs[0].shape[0] * outs[0].shape[1]
        dmean = float((outs[0].mean((0, 1)) - ref.mean((0, 1))).abs().max())
        dstd = float((outs[0].std((0, 1)) / ref.std((0, 1)) - 1).abs().max())
        print(f"  fused_fbank frame-mode dither 1.0 on {what}, {n} frames: "
              f"per-bin mean of the log-mel within {dmean:.4f} of the plain "
              f"version's (torch.randn; bound {DITHER_MEAN_TOL}), standard "
              f"deviation within {dstd:.2%} (bound {DITHER_STD_RTOL:.0%}; "
              f"about {float(ref.std((0, 1)).mean()):.3f}); same seed "
              f"bitwise equal, another seed differs", flush=True)
        if dmean > DITHER_MEAN_TOL or dstd > DITHER_STD_RTOL:
            raise AssertionError(f"dither on {what}: distribution differs")
    # the noise is keyed by the position in the call: two calls on the
    # halves of a batch repeat the first half's noise in the second
    gd.manual_seed(1)
    seed_half = fused(waves[:TRAIN_B // 2], generator=gd)[0]
    if not torch.equal(seed_half, outs[0][:TRAIN_B // 2]):
        raise AssertionError("dither: the first half of a batch must not "
                             "depend on the batch size")
    bench = {"tcn": (tw, dil, k, c, n_layers, pad_max),
             "fsmn": (fw, orders, ld, pd, n_fsmn, pad),
             "fbank": (fused, plain, waves)}
    return errs, bench


def phase11_fsmn_ctc(dev, gen, work, waves, launches):
    """Path B: the hi_xiaowen FSMN-CTC model through the single-stream
    engine.  Returns the mean ``forward()`` time per 300 ms chunk of the
    fused engine."""
    import torch
    import yaml

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.ops.fused_fsmn import fused_fsmn_layers
    from wekws_tpu_torch.ops.serving import build_fused_forward
    from wekws_tpu_torch.runtime import KeyWordSpotter

    model, model_conf = seeded_model(FSMN_MODEL_CONF, gen)
    configs = {"dataset_conf": FSMN_DATASET_CONF, "model": model_conf}
    ckpt = os.path.join(work, "fsmn_ctc.pt")
    config_path = os.path.join(work, "fsmn_ctc.yaml")
    token_path = os.path.join(work, "tokens.txt")
    lexicon_path = os.path.join(work, "lexicon.txt")
    torch.save(model.state_dict(), ckpt)
    with open(config_path, "w") as f:
        yaml.safe_dump(configs, f)
    with open(token_path, "w") as f:
        f.write("<blk> 0\n<filler> 1\n")
        f.writelines(f"t{i} {i}\n" for i in range(2, FSMN_VOCAB))
    with open(lexicon_path, "w") as f:
        f.write(CTC_KEYWORD + " "
                + " ".join(f"t{i}" for i in CTC_KEYWORD_TOKENS) + "\n")
    n_params = sum(p.numel() for p in model.parameters())

    def engine(use_fused):
        spot = KeyWordSpotter(ckpt, config_path, token_path, lexicon_path,
                              threshold=0.5, min_frames=1, use_fused=use_fused,
                              device=dev)
        spot.set_keywords(CTC_KEYWORD)
        if spot.keywords_token[CTC_KEYWORD]["token_id"] != CTC_KEYWORD_TOKENS:
            raise AssertionError(f"keyword tokens {spot.keywords_token}")
        return spot

    def stream(spot):
        """Every utterance in 300 ms chunks -> posteriors per utterance,
        results, chunks that carried frames, seconds inside forward()."""
        probs, results, carried, spent = [], [], 0, 0.0
        orig = spot._apply_step

        def capture(feats, cache):
            out, c = orig(feats, cache)
            probs[-1].append(out)
            return out, c

        spot._apply_step = capture
        for w in waves:
            spot.reset_all()
            probs.append([])
            pcm = w.astype("<i2").tobytes()
            for off in range(0, len(pcm), 2 * CHUNK_SAMPLES):
                t0 = time.perf_counter()
                results.append(spot.forward(pcm[off:off + 2 * CHUNK_SAMPLES]))
                spent += time.perf_counter() - t0
            carried += len(probs[-1])
        spot._apply_step = orig
        return ([torch.cat(p, dim=1)[0] for p in probs], results, carried,
                spent)

    fused, plain = engine(True), engine(False)
    stream(fused)  # warm-up: the library load and first launches
    fused_fsmn_layers.launches = 0
    got, got_results, carried, spent = stream(fused)
    torch.cuda.synchronize()
    launches["fused_fsmn_layers"] = fused_fsmn_layers.launches
    want, want_results, _, plain_spent = stream(plain)
    n_chunks = len(got_results)
    if launches["fused_fsmn_layers"] != carried or carried < 6 * len(waves):
        raise AssertionError(
            f"fused_fsmn_layers launched {launches['fused_fsmn_layers']} "
            f"times for {carried} chunks that carried frames")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        # the streaming frontend may hold back the last frames
        if g.shape[1] != FSMN_VOCAB or not 60 <= g.shape[0] <= 66:
            raise AssertionError(f"utterance {i}: posteriors {tuple(g.shape)}")
        worst = max(worst, check_close(
            f"utterance {i} fused vs module posteriors", g, w, quiet=True))
    if got_results != want_results:
        raise AssertionError("fused and module engines' results differ")
    chunk_ms = spent / n_chunks * 1e3
    print(f"  FSMN-CTC: {n_params} parameters, {FSMN_VOCAB} tokens; "
          f"{len(waves)} utterances x {n_chunks // len(waves)} chunks of "
          f"300 ms: fused vs module softmax posteriors max_abs_err "
          f"{worst:.3e} (bound {TOL} abs + {TOL} rel), result dicts equal; "
          f"fused_fsmn_layers launches {carried} = chunks that carried "
          f"frames; mean forward() {chunk_ms:.3f} ms per chunk fused, "
          f"{plain_spent / n_chunks * 1e3:.3f} ms module (host clock, host "
          f"frontend and decoder included)", flush=True)

    # whole utterances through build_fused_forward(softmax=True)
    cvp = DeviceFeaturePipeline.from_conf(FSMN_DATASET_CONF, training=False)
    wav = torch.as_tensor(waves.astype(np.float32), device=dev)
    lens = torch.full((len(waves),), wav.shape[1], device=dev)
    with torch.no_grad():
        feats, feat_lengths = cvp(wav, lens)
    before = fused_fsmn_layers.launches
    probs = build_fused_forward(fused.model, softmax=True, device=dev)(
        feats, feat_lengths)
    with torch.inference_mode():
        module_probs, _ = fused.model(feats, lengths=feat_lengths,
                                      softmax=True)
    check_close(f"build_fused_forward(softmax=True) {tuple(probs.shape)} vs "
                f"module forward", probs, module_probs)
    if fused_fsmn_layers.launches != before + 1:
        raise AssertionError("the offline FSMN forward must launch once")
    launches["fused_fsmn_layers"] += 1
    launches["fsmn_offline"] = 1
    # streamed == offline (device features match the host frontend's)
    check_close("streamed utterance 0 vs offline posteriors", got[0],
                probs[0, :got[0].shape[0]], atol=1e-3, rtol=1e-3)

    # the detector fires on injected keyword posteriors (random weights
    # never do): tokens at pre-skip frames 30, 60 and 90
    if any(r.get("state") for r in got_results if r):
        raise AssertionError("random weights fired the detector")
    frames = dict(zip((30, 60, 90), CTC_KEYWORD_TOKENS))

    def inject(feats, cache):
        t = feats.shape[1]
        out = np.full((1, t, FSMN_VOCAB), 1e-5, np.float32)
        out[:, :, 0] = 0.9
        for i in range(t):
            tok = frames.get(int(fused._frame_indices[i]))
            if tok is not None:
                out[0, i, 0] = 0.05
                out[0, i, tok] = 0.9
        return out, cache

    fused.reset_all()
    fused._apply = inject
    pcm = waves[0].astype("<i2").tobytes()
    hits = []
    for off in range(0, len(pcm), 2 * CHUNK_SAMPLES):
        res = fused.forward(pcm[off:off + 2 * CHUNK_SAMPLES])
        if res and res.get("state") == 1:
            hits.append(res)
    if (len(hits) != 1 or hits[0]["keyword"] != CTC_KEYWORD
            or abs(hits[0]["start"] - 0.30) > 0.02
            or abs(hits[0]["end"] - 0.90) > 0.02):
        raise AssertionError(f"detector on injected posteriors: {hits}")
    print(f"  detector on injected keyword posteriors: {hits[0]}",
          flush=True)
    return chunk_ms


def phase12_fused_frontend(dev, trainer, conf, batch, launches):
    """Path C: the phase-7 trainer's configuration with ``fused_frontend:
    True``.  Returns the fused-frontend trainer and its state."""
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank
    from wekws_tpu_torch.train import Trainer

    fused_conf = dict(TRAIN_DATASET_CONF, fused_frontend=True)
    plain_fused = dict(fused_conf, spec_aug=False)
    plain_fused["fbank_conf"] = dict(fused_conf["fbank_conf"], dither=0.0)
    frame_conf = dict(fused_conf)
    frame_conf["fbank_conf"] = dict(fused_conf["fbank_conf"],
                                    dither_mode="frame")
    plain_unfused = dict(plain_fused, fused_frontend=False)
    cv_fused = DeviceFeaturePipeline.from_conf(fused_conf, training=False)

    def trainer_for(dataset_conf, cvp):
        model = init_model(conf, torch.Generator().manual_seed(SEED))
        model.load_state_dict(trainer.model.state_dict())
        return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                       cvp, "max_pooling", grad_clip=5.0, min_duration=5,
                       device=dev)

    fused = trainer_for(plain_fused, cv_fused)
    twin = trainer_for(plain_unfused, trainer.cv_pipeline)
    state, twin_state = fused.init_state(), twin.init_state()
    waves = torch.as_tensor(batch["waves"], device=dev)
    lengths = torch.as_tensor(batch["wave_lengths"], device=dev)

    fused_fbank.launches = 0
    expected = 0
    with torch.no_grad():
        feats, feat_lengths = fused.pipeline(waves, lengths)
        want_feats, want_lengths = twin.pipeline(waves, lengths)
    expected += 1
    check_close("step-0 features, fused vs unfused frontend", feats,
                want_feats, atol=FBANK_ATOL, rtol=FBANK_RTOL)
    if not torch.equal(feat_lengths, want_lengths):
        raise AssertionError("feature lengths differ")
    loss, _ = fused.loss_and_grads(state, batch, SEED)
    want_loss, _ = twin.loss_and_grads(twin_state, batch, SEED)
    expected += 1
    err = abs(float(loss) - float(want_loss))
    if err > 1e-5 * abs(float(want_loss)):
        raise AssertionError(f"step-0 loss {float(loss)} vs unfused "
                             f"frontend {float(want_loss)}")
    losses = {}
    for name, dataset_conf in (("wave-mode dither + spec_aug", fused_conf),
                               ("frame-mode (in-kernel) dither + spec_aug",
                                frame_conf)):
        fused.pipeline = DeviceFeaturePipeline.from_conf(dataset_conf)
        losses[name] = []
        for _ in range(2):
            state, metrics = fused.train_step(state, batch, SEED, 1e-3)
            losses[name].append(float(metrics["loss"]))
            expected += 1
    cv = fused.cv_step(state, batch)
    expected += 1
    torch.cuda.synchronize()
    cv_loss = float(cv["loss_sum"]) / max(float(cv["count"]), 1.0)
    flat = [v for vs in losses.values() for v in vs] + [cv_loss]
    if not all(np.isfinite(flat)) or int(cv["count"]) != TRAIN_B:
        raise AssertionError(f"fused-frontend steps: {losses}, cv {cv}")
    launches["fused_fbank"] = fused_fbank.launches
    if fused_fbank.launches != expected:
        raise AssertionError(f"fused_fbank launched {fused_fbank.launches} "
                             f"times, expected {expected}")
    print(f"  step 0 vs the unfused frontend: loss {float(loss):.6f} (diff "
          f"{err:.2e}); losses "
          + "; ".join(f"{k}: {[round(v, 5) for v in vs]}"
                      for k, vs in losses.items())
          + f"; cv loss {cv_loss:.5f}; fused_fbank launches {expected} "
          f"(1 feature call, 1 loss, 4 train steps, 1 cv step)", flush=True)
    fused.pipeline = DeviceFeaturePipeline.from_conf(fused_conf)
    return fused, state


def phase13_times(dev, bench, errs, launches, card, trainer, state,
                  fused_trainer, fused_state, batch, step_ms, chunk_ms):
    """Per-call times of the three later kernels at their main shapes
    (CUDA events, median of 30; device time from the profiler) beside
    the plain version and the bound; the path-C train step beside the
    unfused-frontend step.  Returns their records."""
    import torch

    from wekws_tpu_torch.ops.fused_fsmn import (
        fused_fsmn_layers,
        fused_fsmn_layers_plain,
    )
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn, fused_ds_tcn_plain

    gen = torch.Generator().manual_seed(SEED + 13)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def timed(name, shape, kern, plain, kernel_name, bound):
        # plain, kernel, kernel, plain: report the second of each
        cuda_time_ms(plain)
        cuda_time_ms(kern)
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain)
        dev_ms = profiled_device_ms(kern, kernel_name)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  {name} {shape}: kernel {ms:.4f} ms per call (device time "
              f"{dev_txt}), plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]}); library: none (no single PyTorch call "
              f"computes it) [{card}]", flush=True)
        return {"shape": shape, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}

    def record(name, source, replaces, main, also):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shape": main["shape"], "device_ms": main["device_ms"],
                "also": also}

    out = []
    tw, dil, k, c, n_layers, pad_max = bench["tcn"]
    rows = []
    for b, t in ((N_UTTS, 8), (N_UTTS, 198)):  # streaming step, offline
        x, cache = randn(b, t, c), randn(n_layers, b, pad_max, c)
        rows.append(timed(
            "fused_ds_tcn", f"B={b} T={t}",
            lambda: fused_ds_tcn(x, cache, *tw, dil, k),
            lambda: fused_ds_tcn_plain(x, cache, *tw, dil, k),
            "fused_tcn_kernel", tcn_bound_ms(b, t, c, n_layers, k, pad_max)))
    out.append(record("fused_ds_tcn", "wekws_tpu_torch/csrc/fused_tcn.cu",
                      "wekws_tpu/ops/fused_tcn.py:29", rows[0], rows[1:]))

    fw, orders, ld, pd, n_fsmn, pad = bench["fsmn"]
    rows = []
    for b, t in ((1, 10), (N_UTTS, 66)):  # the engine's chunk, offline
        x, cache = randn(b, t, ld).relu(), randn(n_fsmn, b, pad, pd)
        rows.append(timed(
            "fused_fsmn_layers", f"B={b} T={t}",
            lambda: fused_fsmn_layers(x, cache, *fw, *orders),
            lambda: fused_fsmn_layers_plain(x, cache, *fw, *orders),
            "fused_fsmn_kernel",
            fsmn_bound_ms(b, t, ld, pd, n_fsmn, orders[0], orders[1], pad)))
    out.append(record("fused_fsmn_layers",
                      "wekws_tpu_torch/csrc/fused_fsmn.cu",
                      "wekws_tpu/ops/fused_fsmn.py:29", rows[0], rows[1:]))

    fused, plain, waves = bench["fbank"]
    cfg = fused.cfg
    main = timed(
        "fused_fbank", f"waves {tuple(waves.shape)} M={cfg.num_mel_bins}",
        lambda: fused(waves), lambda: plain(waves), "fused_fbank_kernel",
        fbank_bound_ms(waves.shape[0], waves.shape[1], cfg.frame_length,
                       cfg.frame_shift, cfg.padded_window_size // 2 + 1,
                       cfg.num_mel_bins, cfg.feat_dim))
    out.append(record("fused_fbank", "wekws_tpu_torch/csrc/fused_frontend.cu",
                      "wekws_tpu/ops/fused_frontend.py:111", main, []))

    # the path-C train step beside the unfused-frontend step: unfused
    # (phase 8), fused, fused, unfused
    def step_time(tr, st, reps=10):
        for _ in range(2):
            tr.train_step(st, batch, SEED, 1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(st, batch, SEED, 1e-3)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    step_time(fused_trainer, fused_state)
    fused_ms = step_time(fused_trainer, fused_state)
    unfused_ms = step_time(trainer, state)
    audio = TRAIN_B * TRAIN_SECONDS
    print(f"  train step B={TRAIN_B} x {TRAIN_SECONDS} s, fused_train, "
          f"dither + spec_aug: {fused_ms:.3f} ms with fused_frontend "
          f"({audio / fused_ms * 1e3:.1f} audio-s/s), {unfused_ms:.3f} ms "
          f"without ({audio / unfused_ms * 1e3:.1f} audio-s/s; phase 8 had "
          f"{step_ms:.3f} ms) [{card}]", flush=True)
    print(f"  KeyWordSpotter(use_fused=True).forward: {chunk_ms:.3f} ms per "
          f"300 ms chunk (FSMN-CTC, host clock, phase 11) [{card}]",
          flush=True)
    return out


TRAIN_REPLACES = {
    "f1": "wekws_tpu/ops/fused_mdtc_train.py:100",
    "f2": "wekws_tpu/ops/fused_mdtc_train.py:111",
    "f3": "wekws_tpu/ops/fused_mdtc_train.py:131",
    "f4": "wekws_tpu/ops/fused_mdtc_train.py:161",
    "b1": "wekws_tpu/ops/fused_mdtc_train.py:180",
    "b2": "wekws_tpu/ops/fused_mdtc_train.py:198",
    "b3": "wekws_tpu/ops/fused_mdtc_train.py:231",
    "b4": "wekws_tpu/ops/fused_mdtc_train.py:284",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops.fused_mdtc import (
        extract_mdtc_weights,
        fused_mdtc_forward,
        fused_mdtc_forward_plain,
        fused_mdtc_stream,
        fused_mdtc_stream_plain,
        init_stream_cache,
    )
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn

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
        # the four redesigned passes by name: 128 registers or fewer
        # leave two blocks of 256 threads on an SM
        found = 0
        train_log = cuda_build.build_logs.get("fused_mdtc_train", "")
        for entry, regs, st, ld in cuda_build.parse_ptxas_log(train_log):
            for kern in REDESIGNED_KERNELS:
                width = entry.partition(f"{kern}ILi")[2].partition("E")[0]
                if width:
                    found += 1
                    print(f"  fused_mdtc_train {kern}<{width}>: {regs} "
                          f"registers, {st} bytes spill stores, {ld} bytes "
                          f"spill loads")
        if train_log and found != 3 * len(REDESIGNED_KERNELS):
            # (no log when the library was there)
            raise AssertionError(f"expected ptxas lines for "
                                 f"{', '.join(REDESIGNED_KERNELS)} at C = "
                                 f"32, 64, 128, found {found}")
        print(f"  built {len(paths)} librar(ies) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    model, _ = seeded_model(FLAGSHIP_MODEL_CONF, gen)
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
        n_frames = serving_slice(
            "flagship", FLAGSHIP_MODEL_CONF, gen, dev, work, waves,
            fused_mdtc_forward, fused_mdtc_stream, launches)

    record = []
    with phase("5 times"):
        shapes = {
            "fused_mdtc_forward": [(64, 198), (4, 1024), (N_UTTS, n_frames)],
            "fused_mdtc_stream": [(N_UTTS, 8)],
        }
        main_shape = {"fused_mdtc_forward": (N_UTTS, n_frames),
                      "fused_mdtc_stream": (N_UTTS, 8)}
        launch_key = {"fused_mdtc_forward": "flagship_offline",
                      "fused_mdtc_stream": "flagship_stream"}
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
                        "launches": launches[launch_key[name]],
                        "max_abs_err": errs[name],
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": None,
                    })

    with phase("6 training kernels vs plain (flagship width)"):
        train_errs, main_calls = phase6_train_kernels(dev, gen)

    with phase("7 training slice end to end"):
        train_dir = os.path.join(work, "train")
        os.makedirs(train_dir, exist_ok=True)
        trainer, state, batch, train_conf = phase7_train_slice(
            dev, train_dir, launches)

    with phase("8 training times"):
        train_record, step_ms = phase8_train_times(
            trainer, state, batch, card, launches, train_errs, main_calls)
        record += train_record

    with phase("9 DS-TCN, FSMN and fbank kernels vs plain (full width)"):
        errs3, bench = phase9_new_kernels(dev, gen, batch)

    with phase("10 path A: DS-TCN served end to end"):
        serving_slice("ds_tcn", DS_TCN_MODEL_CONF, gen, dev, work, waves,
                      fused_ds_tcn, fused_ds_tcn, launches)
        launches["fused_ds_tcn"] = (launches["ds_tcn_offline"]
                                    + launches["ds_tcn_stream"])

    with phase("11 path B: FSMN-CTC served by KeyWordSpotter"):
        chunk_ms = phase11_fsmn_ctc(dev, gen, work, waves, launches)

    with phase("12 path C: training with the fused frontend"):
        fused_trainer, fused_state = phase12_fused_frontend(
            dev, trainer, train_conf, batch, launches)

    with phase("13 times of the later kernels and paths"):
        record += phase13_times(dev, bench, errs3, launches, card, trainer,
                                state, fused_trainer, fused_state, batch,
                                step_ms, chunk_ms)

    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
