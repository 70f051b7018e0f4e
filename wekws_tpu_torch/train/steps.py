"""Train and cv steps on the device.

Port of wekws_tpu/train/steps.py.  One train step:

  waveform batch -> DeviceFeaturePipeline (fbank, dither, spec_aug)
    -> KWSModel forward in training mode (exact-BN, fused blocks when
       ``backbone.fused_train``) -> criterion -> autograd
    -> clip by global norm -> L2 weight decay -> Adam

The optimizer is the JAX package's optax chain, written out
(``ClipAdam``): clipping is optax's ``(g / norm) * max_norm`` when
``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
the norm), weight decay is added to the gradient, and Adam divides by
``sqrt(nu_hat) + eps``.  A non-finite gradient is zeroed and the step
runs with learning rate 0, so Adam's moments still decay and its count
still advances, as in the JAX package (the reference wekws skips the
step instead).  No host synchronisation happens inside a step.

The per-step randomness (dither, spec_aug) comes from a generator on
the device seeded from ``(seed, step)``, the counterpart of
``fold_in(rng, step)``.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.losses import criterion, criterion_per_utt


class ClipAdam:
    """optax ``chain(clip_by_global_norm, add_decayed_weights,
    scale_by_adam, scale_by_learning_rate)`` over a list of tensors,
    run on one flattened vector as ``optax.flatten`` does."""

    def __init__(self, params: List[torch.Tensor], grad_clip: float = 5.0,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def step(self, learning_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply the gradients in ``p.grad`` (None counts as zero).
        Returns (grad_norm, skipped) as 0-dim tensors on the device."""
        grads = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1).to(torch.float32) for p in self.params])
        norm = torch.sqrt(torch.sum(grads * grads))
        finite = torch.isfinite(norm)
        grads = torch.where(finite, grads, torch.zeros_like(grads))
        lr = torch.where(finite, torch.tensor(learning_rate, device=norm.device,
                                              dtype=torch.float32),
                         torch.zeros((), device=norm.device))
        # clip_by_global_norm (on the zeroed gradient when non-finite)
        safe_norm = torch.sqrt(torch.sum(grads * grads))
        grads = torch.where(safe_norm < self.grad_clip, grads,
                            (grads / safe_norm) * self.grad_clip)
        flat = torch.cat([p.reshape(-1) for p in self.params])
        if self.weight_decay:
            grads = grads + self.weight_decay * flat
        # scale_by_adam
        self.mu.copy_((1 - self.b1) * grads + self.b1 * self.mu)
        self.nu.copy_((1 - self.b2) * (grads * grads) + self.b2 * self.nu)
        self.count.add_(1)
        count = self.count.to(torch.float32)
        b1 = torch.tensor(self.b1, dtype=torch.float32, device=count.device)
        b2 = torch.tensor(self.b2, dtype=torch.float32, device=count.device)
        mu_hat = self.mu / (1 - b1 ** count)
        nu_hat = self.nu / (1 - b2 ** count)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        # scale_by_learning_rate, apply_updates
        flat = flat + (-lr) * update
        at = 0
        for p in self.params:
            p.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        return norm, (~finite).to(torch.float32)


def make_optimizer(params, grad_clip: float = 5.0,
                   weight_decay: float = 0.0) -> ClipAdam:
    """Adam preceded by global-norm clipping and (torch-style) L2
    weight decay folded into the gradient; the learning rate is given
    to every ``step``."""
    return ClipAdam(params, grad_clip, weight_decay)


@dataclass
class TrainState:
    """The model (parameters and BN buffers, on the device), the
    optimizer state and the step count."""

    step: int
    model: torch.nn.Module
    optimizer: ClipAdam


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """Generator for one step's dither and spec_aug draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + int(step)) % (2 ** 63))
    return gen


class Trainer:
    """Train/cv steps for a (model, pipeline, criterion) on ``device``
    (CUDA unless the caller asks for the CPU).  The model is moved to
    the device; each ``train_step`` takes its learning rate."""

    def __init__(
        self,
        model: torch.nn.Module,
        pipeline: DeviceFeaturePipeline,
        cv_pipeline: DeviceFeaturePipeline,
        criterion_type: str,
        grad_clip: float = 5.0,
        weight_decay: float = 0.0,
        min_duration: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.pipeline = pipeline
        self.cv_pipeline = cv_pipeline
        self.criterion_type = criterion_type
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.min_duration = min_duration

    def init_state(self) -> TrainState:
        params = [p for p in self.model.parameters() if p.requires_grad]
        return TrainState(step=0, model=self.model,
                          optimizer=make_optimizer(params, self.grad_clip,
                                                   self.weight_decay))

    def _tensors(self, batch: Dict):
        def dev(key, dtype):
            val = batch.get(key)
            if val is None:
                return None
            return torch.as_tensor(val).to(self.device, dtype)

        return {
            "waves": dev("waves", torch.float32),
            "wave_lengths": dev("wave_lengths", torch.int64),
            "target": dev("target", torch.int64),
            "target_lengths": dev("target_lengths", torch.int64),
            "valid": dev("valid", torch.float32),
        }

    def loss_and_grads(self, state: TrainState, batch: Dict, seed: int):
        """Forward in training mode and backward: fills ``p.grad`` and
        updates the BN running statistics.  Returns (loss, acc)."""
        model = state.model
        model.train()
        b = self._tensors(batch)
        gen = step_generator(seed, state.step, self.device)
        feats, feat_lengths = self.pipeline(b["waves"], b["wave_lengths"],
                                            generator=gen)
        logits, _ = model(feats, lengths=feat_lengths)
        loss, acc = criterion(self.criterion_type, logits, b["target"],
                              feat_lengths, b["target_lengths"],
                              self.min_duration, valid=b["valid"])
        model.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach(), acc.detach()

    def train_step(self, state: TrainState, batch: Dict, seed: int,
                   learning_rate: float) -> Tuple[TrainState,
                                                  Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (numpy or tensor dict with
        waves, wave_lengths, target, optional target_lengths/valid).
        Metrics are 0-dim tensors on the device."""
        loss, acc = self.loss_and_grads(state, batch, seed)
        grad_norm, skipped = state.optimizer.step(learning_rate)
        state.step += 1
        return state, {"loss": loss, "acc": acc, "grad_norm": grad_norm,
                       "skipped": skipped}

    @torch.no_grad()
    def _eval(self, state: TrainState, batch: Dict):
        model = state.model
        model.eval()
        b = self._tensors(batch)
        feats, feat_lengths = self.cv_pipeline(b["waves"], b["wave_lengths"])
        logits, _ = model(feats, lengths=feat_lengths)
        loss_b, correct_b = criterion_per_utt(
            self.criterion_type, logits, b["target"], feat_lengths,
            b["target_lengths"], self.min_duration)
        return b, loss_b, correct_b, feat_lengths

    def cv_step(self, state: TrainState, batch: Dict) -> Dict[str,
                                                             torch.Tensor]:
        """Sums over the batch; padded (``valid`` 0) and non-finite
        rows are left out."""
        b, loss_b, correct_b, _ = self._eval(state, batch)
        valid = b["valid"] if b["valid"] is not None else torch.ones_like(
            loss_b)
        ok = valid * torch.isfinite(loss_b).to(torch.float32)
        return {
            "loss_sum": torch.where(ok > 0, loss_b,
                                    torch.zeros_like(loss_b)).sum(),
            "correct_sum": (correct_b * ok).sum(),
            "count": ok.sum(),
        }

    def cv_step_full(self, state: TrainState, batch: Dict):
        """Per-utterance outputs."""
        _, loss_b, correct_b, feat_lengths = self._eval(state, batch)
        return {"loss_b": loss_b, "correct_b": correct_b,
                "feat_lengths": feat_lengths}

    @torch.no_grad()
    def forward(self, state: TrainState, waves, wave_lengths,
                softmax: bool = False):
        """Whole-utterance posteriors for scoring."""
        model = state.model
        model.eval()
        b = self._tensors({"waves": waves, "wave_lengths": wave_lengths})
        feats, feat_lengths = self.cv_pipeline(b["waves"], b["wave_lengths"])
        logits, _ = model(feats, lengths=feat_lengths, softmax=softmax)
        return logits, feat_lengths
