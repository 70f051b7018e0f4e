#!/usr/bin/env python3
"""Generate a synthetic token-sequence corpus for the CTC path.

Zero-download analog of the hi_xiaowen CTC recipe: four "phones"
1/2/3/4 are distinct tones; an utterance is a random 3-6 token
sequence rendered as tone segments with pitch/level/duration jitter
over a noise floor.  The wake sequence is "123": keyword utterances
contain it as a contiguous subsequence, fillers are sequences that
avoid it (including hard-negative permutations like "132"/"213").
Writes {train,dev,test}.list with ``txt`` token strings plus the
dict/ token table.

The PyTorch port's copy of gen_data.py (the same corpus, byte for
byte), writing its wavs through wekws_tpu_torch.  Like gen_data.py it
writes dict/dict.txt into the working directory: run it from the
directory that should hold it.
"""

import argparse
import json
import os

import numpy as np

SR = 16000
# digit token names: split_mixed_label keeps LATIN runs whole (words)
# but splits digits per character, so "4123" tokenizes to 4/1/2/3 —
# required for CTC labels and for the DET loader's token-substring
# keyword matching
TONES = {"1": 500.0, "2": 800.0, "3": 1150.0, "4": 1500.0}
KEYWORD = "123"


def render(rng, seq):
    pieces = [0.02 * rng.standard_normal(int(SR * 0.12)).astype(np.float32)]
    for ch in seq:
        f = TONES[ch] * (1 + 0.04 * rng.standard_normal())
        d = int(SR * (0.16 + 0.08 * rng.random()))
        a = 0.2 + 0.2 * rng.random()
        tone = a * np.sin(2 * np.pi * f * np.arange(d) / SR)
        tone += 0.02 * rng.standard_normal(d)
        pieces.append(tone.astype(np.float32))
        gap = int(SR * 0.04 * rng.random())
        pieces.append(0.02 * rng.standard_normal(gap).astype(np.float32))
    pieces.append(0.02 * rng.standard_normal(int(SR * 0.12)).astype(np.float32))
    return np.concatenate(pieces)


def random_seq(rng, with_keyword):
    letters = list(TONES)
    while True:
        n = int(rng.integers(3, 7))
        seq = "".join(rng.choice(letters) for _ in range(n))
        if with_keyword:
            pos = int(rng.integers(0, max(n - 3, 0) + 1))
            seq = seq[:pos] + KEYWORD + seq[pos + 3:]
            return seq
        if KEYWORD not in seq:
            return seq


def write_split(out_dir, split, count, rng):
    from wekws_tpu_torch.data.audio import write_wav

    wav_dir = os.path.join(out_dir, split)
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i in range(count):
        with_kw = i % 2 == 0
        seq = random_seq(rng, with_kw)
        wave = render(rng, seq)
        path = os.path.join(wav_dir, f"{split}_{i}.wav")
        write_wav(path, wave, SR)
        lines.append(json.dumps({
            "key": f"{split}_{i}", "txt": seq,
            "wav": os.path.abspath(path),
            "duration": len(wave) / SR,
        }))
    with open(os.path.join(out_dir, f"{split}.list"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("--train", type=int, default=480)
    parser.add_argument("--dev", type=int, default=96)
    parser.add_argument("--test", type=int, default=192)
    parser.add_argument("--seed", type=int, default=17)
    args = parser.parse_args()
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for split, count in (("train", args.train), ("dev", args.dev),
                         ("test", args.test)):
        write_split(args.out_dir, split, count, rng)
    os.makedirs("dict", exist_ok=True)
    with open("dict/dict.txt", "w") as f:
        f.write("<blank> 0\n<filler> 1\n")
        for i, ch in enumerate(TONES):
            f.write(f"{ch} {i + 2}\n")
    print(f"wrote CTC corpus under {args.out_dir}; keyword = {KEYWORD}")


if __name__ == "__main__":
    main()
