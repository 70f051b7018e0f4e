"""Inputs made from the seed, on the device, in a few large calls.

- Weights: one normal draw for every tensor of the model's state, cut
  by name: a matrix or kernel ``z / sqrt(fan_in)`` (fan_in = its size
  over its first dimension), the head's ``z / (16 sqrt(fan_in))``, a
  BatchNorm scale ``1 + 0.1 z``, a bias ``0.1 z``; running statistics 0
  and 1.  The head is scaled down so that a deep backbone's large
  outputs do not saturate the sigmoid, where the loss is clamped and no
  gradient flows.
- Waves: ``rows`` utterances of ``seconds`` at ``sample_rate``, int16
  scale: three tones (100-3000 Hz) and white noise under a 2-6 Hz
  envelope that never falls below a fifth, at a level drawn per row
  from ``level`` (the int16 amplitude of the tones), as int16.
- Labels: each utterance's keyword in ``[-1, output_dim)`` (-1 a
  filler), uniform.

The traffic file (``kwsbench/traffic/<name>.json``) gives the sizes; the
seed the values.  Every seed gives the same sizes.
"""

import math
from typing import Dict

import torch

HEAD = "classifier."
HEAD_SCALE = 1.0 / 16
# separate streams for the weights, the waves and the labels
STREAM = {"weights": 1, "waves": 2, "labels": 3, "dropout": 4}


def stream_seed(seed: int, stream: str) -> int:
    return (int(seed) * 7919 + STREAM[stream]) % (2 ** 63)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def model_weights(shapes: Dict[str, torch.Size], seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """Float32 tensors for ``shapes`` (a model's state, names to
    shapes) by the rule above."""
    names = [n for n in shapes if not n.endswith("num_batches_tracked")]
    total = sum(math.prod(shapes[n]) for n in names)
    z = torch.randn(total, generator=generator(seed, "weights", device),
                    device=device)
    out, at = {}, 0
    for name in names:
        shape = shapes[name]
        n = math.prod(shape)
        v = z[at:at + n].view(shape)
        at += n
        if name.endswith("running_mean"):
            v = torch.zeros_like(v)
        elif name.endswith("running_var"):
            v = torch.ones_like(v)
        elif name.endswith("bias"):
            v = 0.1 * v
        elif len(shape) == 1:  # a BatchNorm's scale
            v = 1.0 + 0.1 * v
        else:
            v = v / math.sqrt(n / shape[0])
            if name.startswith(HEAD):
                v = v * HEAD_SCALE
        out[name] = v.contiguous()
    return out


def waves(rows: int, traffic: dict, seed: int, device,
          chunk: int = 500) -> torch.Tensor:
    """(rows, S) int16 waves by the rule above, ``chunk`` rows a call."""
    sr = traffic["sample_rate"]
    s = int(round(traffic["seconds_per_row"] * sr))
    lo, hi = traffic["level"]
    gen = generator(seed, "waves", device)
    out = torch.empty((rows, s), dtype=torch.int16, device=device)
    t = torch.arange(s, device=device, dtype=torch.float32) / sr
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        u = torch.rand((n, 9), generator=gen, device=device)
        level = lo + (hi - lo) * u[:, 0:1]
        freq = 100.0 + 2900.0 * u[:, 1:4]
        phase = 2 * math.pi * u[:, 4:7]
        env_f = 2.0 + 4.0 * u[:, 7:8]
        env_p = 2 * math.pi * u[:, 8:9]
        x = torch.randn((n, s), generator=gen, device=device)
        for j in range(3):
            x += 3.0 * torch.sin(2 * math.pi * freq[:, j:j + 1] * t
                                 + phase[:, j:j + 1])
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * env_f * t + env_p)
        x = x * env * level / 3.0
        out[r0:r0 + n] = torch.clamp(torch.round(x), -32768,
                                     32767).to(torch.int16)
    return out


def labels(rows: int, output_dim: int, seed: int, device) -> torch.Tensor:
    return torch.randint(-1, output_dim, (rows,),
                         generator=generator(seed, "labels", device),
                         device=device, dtype=torch.int32)
