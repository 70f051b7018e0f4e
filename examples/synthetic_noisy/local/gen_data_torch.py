#!/usr/bin/env python3
"""Generate the noisy synthetic wake-word setup.

Extends examples/synthetic (same two-tone keyword / hard-negative
fillers) with everything the reference's best published numbers depend
on (hi_xiaowen run_fsmn_ctc.sh lmdb corpora, processor.py:374-430):

* a NOISE corpus (``noise_*`` broadband + ``music_*`` tonal keys, so
  the per-prefix SNR ranges of add_noise both fire) packed into a
  blobstore via tools/make_blob;
* a REVERB corpus of synthetic exponentially-decaying RIRs;
* clean {train,dev}.list (augmentation is applied on the fly at train
  time) and TWO test splits: test.list (clean) and test_noisy.list
  (keyword/filler mixed with held-out noise at 0-10 dB SNR + reverb,
  deterministic) — the aug-vs-clean DET comparison set.

The PyTorch port's copy of gen_data.py (the same corpus), writing its
wavs with wekws_tpu_torch.data.audio.write_wav and its stores with
wekws_tpu_torch.tools.make_blob; the waveform helpers come from
examples/synthetic/local/gen_data.py, which imports only numpy.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "..", "..", "synthetic", "local"),
)
from gen_data import SR, filler_wave, keyword_wave  # noqa: E402


def noise_wave(rng, n, kind):
    if kind == "noise":
        # broadband with a random spectral tilt
        w = rng.standard_normal(n)
        tilt = 0.3 + 0.6 * rng.random()
        w = np.convolve(w, [1.0, -tilt], mode="same")
    else:  # "music": tonal mixture
        w = np.zeros(n)
        for _ in range(3):
            f = 200 + 1800 * rng.random()
            w += np.sin(2 * np.pi * f * np.arange(n) / SR
                        + 2 * np.pi * rng.random())
        w *= 0.3
    return (0.1 * w / (np.sqrt(np.mean(w ** 2)) + 1e-8)).astype(np.float32)


def rir_wave(rng, n=3200):
    """Exponentially decaying sparse reflections (synthetic room)."""
    rir = np.zeros(n, np.float32)
    rir[0] = 1.0
    t = np.arange(n) / SR
    decay = np.exp(-t / (0.05 + 0.15 * rng.random()))
    taps = rng.integers(1, n, 60)
    rir[taps] += 0.5 * rng.standard_normal(60)
    return (rir * decay).astype(np.float32)


def mix_at_snr(rng, wave, noise, snr_db):
    n = len(wave)
    if len(noise) > n:
        start = int(rng.integers(0, len(noise) - n))
        noise = noise[start : start + n]
    else:
        noise = np.resize(noise, (n,))
    sig_db = 10 * np.log10(np.mean(wave ** 2) + 1e-4)
    noi_db = 10 * np.log10(np.mean(noise ** 2) + 1e-4)
    scale = np.sqrt(10 ** ((sig_db - noi_db - snr_db) / 10))
    return (wave + scale * noise).astype(np.float32)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("--train", type=int, default=480)
    parser.add_argument("--dev", type=int, default=96)
    parser.add_argument("--test", type=int, default=192)
    parser.add_argument("--noises", type=int, default=40)
    parser.add_argument("--rirs", type=int, default=12)
    parser.add_argument("--seed", type=int, default=11)
    args = parser.parse_args()

    from wekws_tpu_torch.data.audio import write_wav
    from wekws_tpu_torch.tools.make_blob import make_blob

    rng = np.random.default_rng(args.seed)
    out = args.out_dir
    os.makedirs(out, exist_ok=True)

    # --- augmentation corpora -> blobstores ---
    for corpus, gen in (("noise", None), ("rir", None)):
        wav_dir = os.path.join(out, corpus)
        os.makedirs(wav_dir, exist_ok=True)
        scp = []
        count = args.noises if corpus == "noise" else args.rirs
        for i in range(count):
            if corpus == "noise":
                kind = "noise" if i % 2 == 0 else "music"
                key = f"{kind}_{i}"
                w = noise_wave(rng, SR * 3, kind)
            else:
                key = f"rir_{i}"
                w = rir_wave(rng)
            p = os.path.join(wav_dir, f"{key}.wav")
            write_wav(p, w, SR)
            scp.append(f"{key} {os.path.abspath(p)}")
        scp_path = os.path.join(out, f"{corpus}.scp")
        with open(scp_path, "w") as f:
            f.write("\n".join(scp) + "\n")
        n = make_blob(scp_path, os.path.join(out, f"{corpus}_store"))
        print(f"{corpus}: {n} entries -> {corpus}_store.blob")

    # held-out noises for the noisy TEST split (never in the store)
    test_noises = [noise_wave(rng, SR * 3, "noise") for _ in range(8)]
    test_rirs = [rir_wave(rng) for _ in range(4)]

    # --- speech corpora ---
    for split, n in [("train", args.train), ("dev", args.dev),
                     ("test", args.test)]:
        wav_dir = os.path.join(out, split)
        os.makedirs(wav_dir, exist_ok=True)
        lines, noisy_lines = [], []
        for i in range(n):
            kw = i % 2 == 0
            dur = int(SR * (1.2 + 0.8 * rng.random()))
            w = keyword_wave(rng, dur) if kw else filler_wave(rng, dur)
            p = os.path.join(wav_dir, f"{split}_{i}.wav")
            write_wav(p, w, SR)
            row = {"key": f"{split}_{i}", "txt": "0" if kw else "-1",
                   "wav": os.path.abspath(p), "duration": dur / SR}
            lines.append(json.dumps(row))
            if split == "test":
                from scipy.signal import fftconvolve

                wn = w
                if i % 2 == 0 or i % 3 == 0:  # most utts reverbed
                    rir = test_rirs[i % len(test_rirs)]
                    rir = rir / np.sqrt(np.sum(rir ** 2))
                    wn = fftconvolve(wn, rir, mode="full")[: len(wn)]
                snr = 0.0 + 10.0 * rng.random()
                wn = mix_at_snr(rng, wn.astype(np.float32),
                                test_noises[i % len(test_noises)], snr)
                pn = os.path.join(wav_dir, f"{split}_{i}_noisy.wav")
                write_wav(pn, wn, SR)
                noisy_lines.append(json.dumps({
                    **row, "key": f"{split}_{i}_noisy",
                    "wav": os.path.abspath(pn),
                }))
        with open(os.path.join(out, f"{split}.list"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if noisy_lines:
            with open(os.path.join(out, "test_noisy.list"), "w") as f:
                f.write("\n".join(noisy_lines) + "\n")
        print(f"{split}: {n} utts")


if __name__ == "__main__":
    main()
