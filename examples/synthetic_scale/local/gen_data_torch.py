#!/usr/bin/env python3
"""Generate the reference-scale synthetic wake-word corpus.

The small synthetic recipes (480-768 utts) validate correctness but
cannot exercise bucketing/shuffle/averaging at the reference's
operating point, and their DET FA/h axis rests on <1 filler hour.
This corpus is sized like hey_snips (~11k keyword / 45k filler utts,
the reference wekws's examples/hey_snips/s0/README.md): by default 20k train
utterances and a test split with 10 filler HOURS, so FA/h sweeps down
to ~0.1/h are statistically meaningful.

Every utterance is a fixed 6 s of continuous audio (background noise +
distractor tones); keyword utterances embed the two-tone wake chirp at
a random position with pitch/level jitter and per-utterance SNR.
Fillers include hard negatives (reversed chirp, single tones, tone
triples).  The uniform duration maps 1:1 onto the device-resident
epoch layout (no padding waste).

Writes {train,dev,test}.list under the output dir.

The PyTorch port's copy of gen_data.py (the same arguments and seed,
the same corpus byte for byte), writing its wavs through
wekws_tpu_torch.
"""

import argparse
import json
import os

import numpy as np

SR = 16000
DUR_S = 6.0


def _tone(rng, f, d, a):
    t = np.arange(d) / SR
    # slight AM + attack/decay envelope so tones aren't pure lines
    env = np.minimum(1.0, np.minimum(np.arange(d), d - np.arange(d)) / 400.0)
    return (a * env * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _background(rng, n):
    w = (0.03 + 0.03 * rng.random()) * rng.standard_normal(n)
    # distractor tones scattered through the background
    for _ in range(int(rng.integers(2, 6))):
        f = 300 + 1700 * rng.random()
        d = int(SR * (0.1 + 0.4 * rng.random()))
        off = int(rng.integers(0, n - d - 1))
        w[off:off + d] += _tone(rng, f, d, 0.05 + 0.15 * rng.random())
    return w.astype(np.float32)


def _keyword(rng):
    """Two-tone wake chirp, jittered (the synthetic recipe's keyword)."""
    f1 = 600 * (1 + 0.08 * rng.standard_normal())
    f2 = 900 * (1 + 0.08 * rng.standard_normal())
    d1 = int(SR * 0.25 * (1 + 0.2 * rng.random()))
    d2 = int(SR * 0.25 * (1 + 0.2 * rng.random()))
    a = 0.15 + 0.25 * rng.random()
    gap = int(SR * 0.02 * rng.random())
    return np.concatenate([
        _tone(rng, f1, d1, a),
        np.zeros(gap, np.float32),
        _tone(rng, f2, d2, a),
    ])


def _hard_negative(rng, n, w):
    kind = int(rng.integers(0, 3))
    if kind == 0:  # reversed chirp
        kw = _keyword(rng)[::-1].copy()
    elif kind == 1:  # single long tone at a keyword frequency
        kw = _tone(rng, rng.choice([600.0, 900.0]),
                   int(SR * 0.5), 0.2 + 0.2 * rng.random())
    else:  # tone triple avoiding the 600->900 transition
        kw = np.concatenate([
            _tone(rng, 900, int(SR * 0.2), 0.3),
            _tone(rng, 1300, int(SR * 0.2), 0.3),
            _tone(rng, 600, int(SR * 0.2), 0.3),
        ])
    off = int(rng.integers(0, n - len(kw) - 1))
    w[off:off + len(kw)] += kw
    return w


def make_utt(rng, is_keyword):
    n = int(SR * DUR_S)
    w = _background(rng, n)
    if is_keyword:
        kw = _keyword(rng)
        off = int(rng.integers(SR // 2, n - len(kw) - SR // 2))
        w[off:off + len(kw)] += kw
    elif rng.random() < 0.5:
        w = _hard_negative(rng, n, w)
    return np.clip(w, -1.0, 1.0)


def write_split(out_dir, split, n_kw, n_filler, rng):
    from wekws_tpu_torch.data.audio import write_wav

    wav_dir = os.path.join(out_dir, split)
    os.makedirs(wav_dir, exist_ok=True)
    order = np.concatenate([np.ones(n_kw, bool), np.zeros(n_filler, bool)])
    rng.shuffle(order)
    lines = []
    for i, is_kw in enumerate(order):
        w = make_utt(rng, bool(is_kw))
        p = os.path.join(wav_dir, f"{split}_{i:06d}.wav")
        write_wav(p, w, SR)
        lines.append(json.dumps({
            "key": f"{split}_{i:06d}",
            "txt": "0" if is_kw else "-1",
            "wav": os.path.abspath(p),
            "duration": DUR_S,
        }))
    with open(os.path.join(out_dir, f"{split}.list"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{split}: {n_kw} keyword + {n_filler} filler utts "
          f"({n_filler * DUR_S / 3600:.1f} filler hours)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--train_kw", type=int, default=5000)
    ap.add_argument("--train_filler", type=int, default=15000)
    ap.add_argument("--dev_kw", type=int, default=500)
    ap.add_argument("--dev_filler", type=int, default=1500)
    ap.add_argument("--test_kw", type=int, default=2000)
    ap.add_argument("--test_filler", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=20260820)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    write_split(args.out_dir, "train", args.train_kw, args.train_filler, rng)
    write_split(args.out_dir, "dev", args.dev_kw, args.dev_filler, rng)
    write_split(args.out_dir, "test", args.test_kw, args.test_filler, rng)


if __name__ == "__main__":
    main()
