"""Device-decode against host-decode hit-score drift on trained
posteriors.

Port of tools/drift_sweep.py, with the same flags and printed lines,
plus ``--device`` (``cuda`` by default, ``cpu`` for the tests; ``cuda``
without a GPU raises).  The batched decoder (decode/device_stream.py)
does not gate its repeat paths as the host beam does (ROADMAP C.4), so
the two can part on unconfident posteriors.  This tool bounds the
effect: every utterance of a test set streams through the batched CTC
engine twice -- host prefix-beam decode and on-device decode -- at
each threshold of a sweep, and it reports

* per threshold, the event-set divergence (utterances that exactly one
  engine detects), and
* the largest |score| gap on utterances that both detect.

The engines take ``forward_route``'s route (``use_fused=None``, as
``bin/serve``): the fused kernel on the card for MDTC, DS-TCN and
FSMN, the modules on the CPU (ROADMAP C.36).

Usage:
    python -m wekws_tpu_torch.tools.drift_sweep --config exp/config.yaml \\
        --checkpoint exp/avg_5.pt --token_file dict/dict.txt \\
        --keywords <kw> --test_data data/test.list \\
        [--thresholds 0.02 0.1 0.3 0.5 0.7] [--device cuda|cpu]
"""

import argparse
import json

import numpy as np


def run_engine(args, wavs, device_decode, threshold):
    from wekws_tpu_torch.runtime import BatchKeywordSpotter

    n = len(wavs)
    spotter = BatchKeywordSpotter(
        args.checkpoint, args.config, args.token_file,
        args.lexicon_file, threshold, num_streams=n,
        step_frames=args.step_frames, min_frames=args.min_frames,
        max_frames=args.max_frames, interval_frames=args.interval_frames,
        device_decode=device_decode, use_fused=None, device=args.device,
    )
    spotter.set_keywords(args.keywords)
    events = {i: [] for i in range(n)}

    def collect(results):
        for i, r in (results or {}).items():
            if r and r.get("state") == 1:
                events[i].append(
                    {"keyword": r["keyword"], "score": float(r["score"]),
                     "end": float(r.get("end", 0.0))}
                )

    chunk = 2 * 4800  # 300 ms
    longest = max(len(p) for p in wavs)
    off = 0
    while off < longest:
        for i in range(n):
            if off < len(wavs[i]):
                spotter.accept_wave(i, wavs[i][off : off + chunk])
        off += chunk
        while True:
            results = spotter.step()
            if not results:
                break
            collect(results)
    collect(spotter.flush())
    return events


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--token_file", required=True)
    ap.add_argument("--lexicon_file", default=None)
    ap.add_argument("--keywords", required=True)
    ap.add_argument("--test_data", required=True)
    ap.add_argument("--thresholds", type=float, nargs="+",
                    default=[0.02, 0.1, 0.3, 0.5, 0.7])
    ap.add_argument("--step_frames", type=int, default=8)
    ap.add_argument("--min_frames", type=int, default=5)
    ap.add_argument("--max_frames", type=int, default=250)
    ap.add_argument("--interval_frames", type=int, default=50)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from wekws_tpu_torch.data.audio import read_wav
    from wekws_tpu_torch.device import resolve_device

    args = get_args(argv)
    args.device = resolve_device(args.device)

    keys, wavs = [], []
    with open(args.test_data) as f:
        for line in f:
            obj = json.loads(line)
            wave, sr = read_wav(obj["wav"])
            pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
            keys.append(obj["key"])
            wavs.append(pcm)
            if args.limit and len(wavs) >= args.limit:
                break

    print(f"{len(wavs)} utts, thresholds {args.thresholds}")
    worst_div, worst_gap = 0.0, 0.0
    for thr in args.thresholds:
        host = run_engine(args, wavs, False, thr)
        dev = run_engine(args, wavs, True, thr)
        diverged, both, gaps = 0, 0, []
        for i in range(len(wavs)):
            h = bool(host[i])
            d = bool(dev[i])
            if h != d:
                diverged += 1
            elif h and d:
                both += 1
                gaps.append(abs(host[i][0]["score"] - dev[i][0]["score"]))
        gap = max(gaps) if gaps else 0.0
        div = diverged / len(wavs)
        worst_div = max(worst_div, div)
        worst_gap = max(worst_gap, gap)
        print(f"thr {thr:4.2f}: divergent {diverged}/{len(wavs)} "
              f"({100 * div:.1f}%), both-detected {both}, "
              f"max score gap {gap:.4f}")
    print(f"SUMMARY: max event-set divergence {100 * worst_div:.1f}%, "
          f"max hit-score gap {worst_gap:.4f} over the sweep")


if __name__ == "__main__":
    main()
