#!/usr/bin/env python3
"""Generate a synthetic N-class "spoken command" corpus.

Self-contained analog of the Speech Commands classification task (no
downloads): class k is a characteristic two-tone pattern — a pair of
class-specific frequencies played in a class-specific order with
random pitch/level/timing jitter over a noise floor.  Classes are
deliberately confusable (shared frequency pool, order matters) so CE
training and accuracy evaluation are non-trivial.  Writes
{train,dev,test}.list with integer ``txt`` labels 0..N-1.

The PyTorch port's copy of gen_data.py (the same corpus, byte for
byte), writing its wavs through wekws_tpu_torch.
"""

import argparse
import json
import os

import numpy as np

SR = 16000
# class -> (f1, f2); adjacent classes share a frequency so order and
# both tones matter
FREQS = [500, 650, 800, 950, 1100, 1250, 1400, 1550]


def command_wave(rng, n, cls, n_classes):
    f1 = FREQS[cls % len(FREQS)]
    f2 = FREQS[(cls + 1) % len(FREQS)]
    if cls % 2 == 1:
        f1, f2 = f2, f1  # odd classes: reversed order of the same pair
    f1 = f1 * (1 + 0.04 * rng.standard_normal())
    f2 = f2 * (1 + 0.04 * rng.standard_normal())
    d1 = int(SR * 0.22 * (1 + 0.2 * rng.random()))
    d2 = int(SR * 0.22 * (1 + 0.2 * rng.random()))
    off = int(rng.integers(0, max(n - d1 - d2 - 800, 1)))
    w = 0.02 * rng.standard_normal(n)
    a = 0.2 + 0.2 * rng.random()
    w[off:off + d1] += a * np.sin(2 * np.pi * f1 * np.arange(d1) / SR)
    w[off + d1:off + d1 + d2] += a * np.sin(
        2 * np.pi * f2 * np.arange(d2) / SR
    )
    return w.astype(np.float32)


def write_split(out_dir, split, count, n_classes, rng):
    from wekws_tpu_torch.data.audio import write_wav

    wav_dir = os.path.join(out_dir, split)
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i in range(count):
        cls = int(i % n_classes)
        n = int(SR * (1.4 + 0.4 * rng.random()))
        wave = command_wave(rng, n, cls, n_classes)
        path = os.path.join(wav_dir, f"{split}_{i}.wav")
        write_wav(path, wave, SR)
        lines.append(json.dumps({
            "key": f"{split}_{i}", "txt": str(cls),
            "wav": os.path.abspath(path), "duration": n / SR,
        }))
    with open(os.path.join(out_dir, f"{split}.list"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("--classes", type=int, default=8)
    parser.add_argument("--train", type=int, default=640)
    parser.add_argument("--dev", type=int, default=128)
    parser.add_argument("--test", type=int, default=256)
    parser.add_argument("--seed", type=int, default=11)
    args = parser.parse_args()
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for split, count in (("train", args.train), ("dev", args.dev),
                         ("test", args.test)):
        write_split(args.out_dir, split, count, args.classes, rng)
    print(f"wrote {args.classes}-class corpus under {args.out_dir}")


if __name__ == "__main__":
    main()
