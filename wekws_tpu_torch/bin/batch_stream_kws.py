"""Batched multi-stream KWS serving CLI.

Port of wekws_tpu/bin/batch_stream_kws.py: streams N wav files
concurrently through ONE batched cached step
(``wekws_tpu_torch.runtime.BatchKeywordSpotter``, or
``BatchMaxPoolSpotter`` with ``--maxpool``) and reports the aggregate
real-time factor.

    python -m wekws_tpu_torch.bin.batch_stream_kws \\
        --config exp/config.yaml --checkpoint exp/avg_5.ckpt \\
        --token_file tokens.txt --keywords ab \\
        --wav_paths a.wav b.wav c.wav [--streams 16]

Fewer wavs than --streams cycles the list (load test); detections are
printed per stream with timestamps.  On the card the engine's route
comes from ``ops.serving.forward_route`` (an artifact directory serves
through the artifact runtime); ``--mesh_devices N`` splits the streams
over the first N cards, and asking for more cards than the machine has
raises (ROADMAP C.21).
"""

import argparse
import logging
import time


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="batched streaming kws")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a port .pt, a JAX-package .ckpt, or an exported "
                             "artifact directory (model.json + "
                             "weights[_int8].bin) to serve a float or "
                             "static-int8 artifact on the device")
    parser.add_argument("--token_file", default=None,
                        help="CTC mode: token table (required unless "
                             "--maxpool)")
    parser.add_argument("--lexicon_file", default=None)
    parser.add_argument("--keywords", default=None,
                        help="CTC mode: comma-separated keywords; "
                             "maxpool mode: optional names for the "
                             "posterior columns")
    parser.add_argument("--wav_paths", nargs="+", required=True)
    parser.add_argument("--streams", type=int, default=None,
                        help="stream slots (default: one per wav)")
    parser.add_argument("--repeat", type=int, default=1,
                        help="loop each wav N times per stream "
                             "(longer feeds for load testing)")
    parser.add_argument("--threshold", type=float, default=0.02)
    parser.add_argument("--min_frames", type=int, default=5)
    parser.add_argument("--max_frames", type=int, default=250)
    parser.add_argument("--interval_frames", type=int, default=50)
    parser.add_argument("--score_beam", type=int, default=3)
    parser.add_argument("--path_beam", type=int, default=20)
    parser.add_argument("--step_frames", type=int, default=8)
    parser.add_argument("--chunk_ms", type=int, default=300)
    parser.add_argument("--device_decode", action="store_true",
                        help="run beam + detection FSM on the device in "
                             "the engine's step (no host beams)")
    parser.add_argument("--maxpool", action="store_true",
                        help="serve a max-pooling (sigmoid) wake-word "
                             "model: threshold + refractory detection "
                             "instead of CTC beams")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="split the streams over the first N cards "
                             "(equal row blocks; more than the machine "
                             "has raises)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns ``{"detections": [(stream, result)], "audio_s", "wall_s",
    "stats"}`` (the engine's step stats)."""
    args = get_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    import numpy as np

    from wekws_tpu_torch.data.audio import read_wav
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.parallel.mesh import mesh_devices
    from wekws_tpu_torch.runtime import (
        BatchKeywordSpotter,
        BatchMaxPoolSpotter,
    )

    device = resolve_device(args.device)
    if args.mesh_devices:
        device = mesh_devices(args.mesh_devices, device)
    n = args.streams or len(args.wav_paths)
    if args.maxpool:
        names = args.keywords.split(",") if args.keywords else None
        spotter = BatchMaxPoolSpotter(
            args.checkpoint, args.config, args.threshold,
            num_streams=n, step_frames=args.step_frames,
            interval_frames=args.interval_frames, keyword_names=names,
            use_fused=None, device=device,
        )
    else:
        if not args.token_file or not args.keywords:
            raise SystemExit(
                "--token_file and --keywords are required in CTC mode"
            )
        spotter = BatchKeywordSpotter(
            args.checkpoint, args.config, args.token_file,
            args.lexicon_file, args.threshold, num_streams=n,
            step_frames=args.step_frames, min_frames=args.min_frames,
            max_frames=args.max_frames,
            interval_frames=args.interval_frames,
            score_beam=args.score_beam, path_beam=args.path_beam,
            device_decode=args.device_decode, use_fused=None,
            device=device,
        )
        spotter.set_keywords(args.keywords)

    pcms = []
    sr = None
    for i in range(n):
        wave, sr = read_wav(args.wav_paths[i % len(args.wav_paths)])
        pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
        pcms.append(pcm * max(args.repeat, 1))
    chunk_bytes = 2 * int(sr * args.chunk_ms / 1000)
    detections = []

    def report(results):
        for i, r in sorted(results.items()):
            if r and r.get("state") == 1:
                detections.append((i, r))
                if args.maxpool:
                    print(
                        f"stream {i}: detect {r['keyword']} "
                        f"at {r['time']:.2f}s score {r['score']:.3f}"
                    )
                else:
                    print(
                        f"stream {i}: detect {r['keyword']} "
                        f"from {r['start']:.2f}s to {r['end']:.2f}s "
                        f"score {r['score']:.3f}"
                    )

    t0 = time.perf_counter()
    off = 0
    longest = max(len(p) for p in pcms)
    while off < longest:
        for i in range(n):
            if off < len(pcms[i]):
                spotter.accept_wave(i, pcms[i][off:off + chunk_bytes])
        off += chunk_bytes
        while True:  # drain all full-size steps this round
            results = spotter.step()
            if not results:
                break
            report(results)
    report(spotter.flush())
    wall = time.perf_counter() - t0
    audio_s = sum(len(p) for p in pcms) / 2 / sr
    print(
        f"served {n} streams, {audio_s:.1f} audio-s in {wall:.2f}s "
        f"(aggregate {audio_s / wall:.1f}x realtime)"
    )
    return {"detections": detections, "audio_s": audio_s, "wall_s": wall,
            "stats": dict(spotter.stats)}


if __name__ == "__main__":
    main()
