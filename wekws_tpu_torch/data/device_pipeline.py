"""Feature pipeline on the device: fbank -> spec_aug -> splice -> skip.

Port of wekws_tpu/data/device_pipeline.py.  The host ships raw padded
waveforms and this pipeline runs inside the train step:

* ``spec_aug``: per-utterance time and frequency zero-masks, drawn
  from a ``torch.Generator`` (``spec_aug_masks``) and applied
  separately (``apply_spec_aug``), so a test can inject the JAX
  package's masks.  Starts lie in ``[0, size)``, lengths in
  ``[1, max_len)``, as the JAX package draws them;
* ``context_expansion``: splice ``[t-left .. t+right]`` along the
  feature axis, the left margin clamped to frame 0, the last ``right``
  frames dropped;
* ``frame_skip``: every Nth frame; ``context_expansion_skip`` is the
  two together, evaluated only at the kept frames.

Device waveform augmentation (``wave_aug``) is not ported yet.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from wekws_tpu_torch.frontend.features import (
    FeatureExtractor,
    frontend_from_dataset_conf,
)


def spec_aug_masks(
    shape: Tuple[int, int, int],
    generator: torch.Generator,
    num_t_mask: int = 2,
    num_f_mask: int = 2,
    max_t: int = 50,
    max_f: int = 10,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> keep masks (B, T) and (B, D), float 0/1."""
    b, t, d = shape
    device = generator.device if device is None else device

    def keep(size, max_len, num_mask):
        starts = torch.randint(0, size, (b, num_mask), generator=generator,
                               device=device)
        # randint(1, 1) is empty in torch; JAX returns 1 there
        lengths = torch.randint(1, max(max_len, 2), (b, num_mask),
                                generator=generator, device=device)
        pos = torch.arange(size, device=device)[None, None, :]
        masked = (pos >= starts[:, :, None]) & (
            pos < (starts + lengths)[:, :, None])
        return (~masked.any(dim=1)).to(torch.float32)

    return keep(t, max_t, num_t_mask), keep(d, max_f, num_f_mask)


def apply_spec_aug(feats: torch.Tensor, keep_t: torch.Tensor,
                   keep_f: torch.Tensor) -> torch.Tensor:
    return feats * keep_t[:, :, None] * keep_f[:, None, :]


def spec_aug(feats: torch.Tensor, generator: torch.Generator,
             num_t_mask: int = 2, num_f_mask: int = 2, max_t: int = 50,
             max_f: int = 10) -> torch.Tensor:
    """Random time/frequency masking over (B, T, D), zeros as fill."""
    keep_t, keep_f = spec_aug_masks(feats.shape, generator, num_t_mask,
                                    num_f_mask, max_t, max_f, feats.device)
    return apply_spec_aug(feats, keep_t, keep_f)


def context_expansion(feats: torch.Tensor, left: int = 1,
                      right: int = 1) -> torch.Tensor:
    """(B, T, D) -> (B, T - right, D * (left + 1 + right))."""
    t = feats.shape[1]
    pos = torch.arange(t, device=feats.device)
    parts = [feats[:, torch.clamp(pos + lag, 0, t - 1), :]
             for lag in range(-left, right + 1)]
    out = torch.cat(parts, dim=-1)
    return out[:, :t - right, :] if right > 0 else out


def frame_skip(feats: torch.Tensor, skip_rate: int = 1) -> torch.Tensor:
    if skip_rate <= 1:
        return feats
    return feats[:, ::skip_rate, :]


def context_expansion_skip(feats: torch.Tensor, left: int, right: int,
                           skip: int) -> torch.Tensor:
    """``frame_skip(context_expansion(x, left, right), skip)``,
    computed only at the kept frames."""
    t = feats.shape[1]
    t_keep = t - right if right > 0 else t
    kept = torch.arange(0, t_keep, skip, device=feats.device)
    parts = [feats[:, torch.clamp(kept + lag, 0, t - 1), :]
             for lag in range(-left, right + 1)]
    return torch.cat(parts, dim=-1)


@dataclass(eq=False)
class DeviceFeaturePipeline:
    """Config-driven waveform -> model-input transform.

    Built from a wekws-style ``dataset_conf``; ``training=False``
    turns dither and spec_aug off (the cv/test settings)."""

    extractor: FeatureExtractor
    spec_aug_conf: Optional[dict]
    context_left: int
    context_right: int
    skip_rate: int
    wave_aug: Optional[object] = None

    @classmethod
    def from_conf(cls, conf: dict, training: bool = True):
        fused = bool(conf.get("fused_frontend", False))
        extractor = frontend_from_dataset_conf(conf, use_fused=fused)
        sa = None
        if training and conf.get("spec_aug", False):
            sa = dict(conf.get("spec_aug_conf", {}))
        if not training:
            extractor = FeatureExtractor(
                dataclasses.replace(extractor.cfg, dither=0.0),
                use_fused=fused)
        left = right = 0
        if conf.get("context_expansion", False):
            ce = conf.get("context_expansion_conf", {})
            left, right = ce.get("left", 1), ce.get("right", 1)
        return cls(extractor=extractor, spec_aug_conf=sa, context_left=left,
                   context_right=right,
                   skip_rate=int(conf.get("frame_skip", 1)))

    @property
    def output_dim(self) -> int:
        base = self.extractor.feat_dim
        if self.context_left or self.context_right:
            return base * (self.context_left + 1 + self.context_right)
        return base

    @property
    def downsample_rate(self) -> int:
        return max(self.skip_rate, 1)

    def feat_lengths(self, wave_lengths: torch.Tensor) -> torch.Tensor:
        n = self.extractor.num_frames(wave_lengths)
        if self.context_right:
            n = torch.clamp(n - self.context_right, min=0)
        if self.skip_rate > 1:
            n = torch.div(n + self.skip_rate - 1, self.skip_rate,
                          rounding_mode="floor")
        return n

    def __call__(
        self,
        waves: torch.Tensor,
        wave_lengths: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) int16-scaled waves -> (B, T', D'), (B,) lengths.
        ``generator`` draws the dither, then the spec_aug masks."""
        if self.wave_aug is not None:
            raise NotImplementedError(
                "device waveform augmentation is not ported yet (ROADMAP "
                "queue A, item 10)")
        feats, _ = self.extractor(waves, None, generator=generator)
        if self.spec_aug_conf is not None and generator is not None:
            sa = self.spec_aug_conf
            feats = spec_aug(feats, generator,
                             num_t_mask=sa.get("num_t_mask", 2),
                             num_f_mask=sa.get("num_f_mask", 2),
                             max_t=sa.get("max_t", 50),
                             max_f=sa.get("max_f", 10))
        left, right = self.context_left, self.context_right
        if (left or right) and self.skip_rate > 1:
            feats = context_expansion_skip(feats, left, right, self.skip_rate)
        else:
            if left or right:
                feats = context_expansion(feats, left, right)
            feats = frame_skip(feats, self.skip_rate)
        return feats, self.feat_lengths(wave_lengths)
