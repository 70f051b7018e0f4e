#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (wekws_tpu_torch).

Drives the flagship MDTC max-pooling wake word (40-mel fbank, global
CMVN, linear preprocessing, MDTC 4 stacks x 4 blocks, kernel 5, 64
channels, linear head + sigmoid; random weights from a seed) on one
CUDA device, in phases; any failure exits non-zero:

1. card name and power limit (nvidia-smi); a GPU is required;
2. build every CUDA kernel from ``wekws_tpu_torch/csrc``;
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
   main path's B=512 x T=198 at dilations 1, 2, 4 and 8 (about eight
   tiles per block of the persistent grid), B=64 x T=198 (one tile
   per block) and a ragged B=5 x T=130 at dilations 1 and 8, and C=32
   once; each pass launched twice must agree bitwise (deterministic
   reductions).  The whole fused block (forward, six batch statistics,
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
   (its kernel and its own block reduction), the plain version's time
   and the bound; the whole train step.

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


def check_close(name, got, want, quiet=False):
    import torch

    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=TOL, rtol=TOL)
    if not quiet or not ok:
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


def train_pass_bound_ms(name, b, t, c, k):
    """Least time on an H100 for one training pass: the larger of the
    compulsory bytes over HBM bandwidth (each (B, T, C) input read once,
    each output written once, weights once) and its fp32 operations
    over the fp32 peak (an FMA counts 2).  Per frame and channel: the
    depthwise conv 2K, each C x C product 2C, the elementwise BN, ReLU
    and exact-BN backward terms as counted below."""
    n = b * t
    act = 4 * n * c  # one (B, T, C) float32 tensor
    w = 4 * c * c
    per_frame = {  # operations per frame
        "f1": c * (2 * k + 3),
        "f2": c * (2 * k + 2) + 2 * c * c + 4 * c,
        "f3": c * (2 * k + 2) + 4 * c * c + 11 * c,
        "f4": 4 * c,
        "b1": 10 * c,
        "b2": 4 * c * c + 20 * c,
        "b3": 8 * c * c + c * (2 * k + 30),
        "b4": 6 * c * c + c * (6 * k + 30),
    }[name]
    nbytes = {
        "f1": act, "f2": act + w, "f3": 3 * act + 2 * w, "f4": 3 * act,
        "b1": 3 * act, "b2": 4 * act + 2 * w, "b3": 4 * act + 3 * w,
        "b4": 5 * act + 2 * w,
    }[name]
    t_ops = n * per_frame / PEAK_FP32_FLOPS * 1e3
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
    # each block of the persistent grid carries its sums across about
    # eight tiles; one tile per block; a ragged batch; C=32
    cases = [(TRAIN_B, 198, 64, d) for d in (1, 2, 4, 8)] + [
        (64, 198, 64, 1), (64, 198, 64, 8), (5, 130, 64, 1),
        (5, 130, 64, 8), (64, 198, 32, 8)]
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
    """Train -> checkpoint -> serve at B=512 x 2 s; returns what phase
    8 reuses."""
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
    return trainer, state, batch


def phase8_train_times(trainer, state, batch, card, launches, errs,
                       calls):
    """Per-pass and whole-step times at B=512 x T=198; ``calls`` holds
    each pass's inputs at that shape (dilation 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wekws_tpu_torch.ops.fused_mdtc_train import PASS_IDS, PASSES

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
    busy = 0.0
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0.0))
        if evt.count and total and str(getattr(evt, "device_type", "")) \
                .endswith("CUDA"):
            busy += total
        kernels[evt.key] = (total, evt.count)
    pass_kernel = {"f1": "fwd_kernel<64, 1>", "f2": "fwd_kernel<64, 2>",
                   "f3": "fwd_kernel<64, 3>", "f4": "f4_kernel<64>",
                   "b1": "bwd_kernel<64, 5>", "b2": "bwd_kernel<64, 6>",
                   "b3": "bwd_kernel<64, 7>", "b4": "bwd_kernel<64, 8>"}

    def dev_ms(fragment):
        for key, (total, count) in kernels.items():
            if fragment in key and count:
                return total / count / 1e3
        return None

    dx_ms = dev_ms("dx_kernel<64>") or 0.0
    ours = list(pass_kernel.values()) + ["reduce_kernel", "dx_kernel<64>"]
    kernel_total = sum(t for key, (t, _) in kernels.items()
                       if any(f in key for f in ours)) / 1e3
    print(f"  profiled step: {busy / 1e3:.3f} ms of device time in all, "
          f"{kernel_total:.3f} ms in the training kernels; the device is "
          f"idle for {max(0.0, 1 - busy / 1e3 / step_ms):.1%} of the "
          f"unprofiled {step_ms:.3f} ms step [{card}]", flush=True)

    record = []
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
        if main is not None and name != "f4":  # its own block reduction
            reduce_ms = dev_ms(f"reduce_kernel<{PASS_IDS[name]}>")
            main = None if reduce_ms is None else main + reduce_ms
        if main is not None and name == "b4":
            main += dx_ms
        dev_txt = "not measured" if main is None else f"{main:.4f} ms"
        if main is not None and reduce_ms is not None:
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
    return record, step_ms


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

    with phase("6 training kernels vs plain (flagship width)"):
        train_errs, main_calls = phase6_train_kernels(dev, gen)

    with phase("7 training slice end to end"):
        train_dir = os.path.join(work, "train")
        os.makedirs(train_dir, exist_ok=True)
        trainer, state, batch = phase7_train_slice(dev, train_dir, launches)

    with phase("8 training times"):
        train_record, _ = phase8_train_times(trainer, state, batch, card,
                                             launches, train_errs, main_calls)
        record += train_record

    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
