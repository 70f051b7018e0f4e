"""Serving SLOs: per-chunk latency percentiles and keyword-detection
delay of the port's CTC engines.

Port of tools/bench_serving_slo.py, with the same flags, defaults,
modes and JSON lines, plus ``--device`` (``cuda`` by default, ``cpu``
for the tests; ``cuda`` without a GPU raises).  Two measurements:

* ``latency``: per-chunk p50/p95/p99 of the batched streaming engine
  (``BatchKeywordSpotter``: feature push, the batched model step and
  the host FSM decode, or the on-device decode) at 1/16/64 concurrent
  streams, each iteration feeding ``--chunk`` frames of new audio to
  every stream.  Each chunk is timed blocked on the host clock: the
  engine's step ends in its copy to the host (the posteriors with host
  decode, the packed (5, N) events with ``--device_decode``), which
  waits for every kernel the step enqueued.  With frame skip or
  subsampling a step only runs once enough model frames have
  accumulated, so chunks split into step-bearing and buffer-only ones,
  reported apart.  Also the real-time factor (audio seconds consumed
  per wall second over the run, all streams).

* ``detection``: keyword-detection delay -- the audio the engine needs
  to see past the keyword's end before the FSM fires.  Utterances carry
  the keyword's tone sequence at known sample positions (the
  examples/synthetic_ctc corpus convention); each streams through
  ``KeyWordSpotter`` in ``--chunk_ms`` chunks, and the tool reports the
  percentiles of (activation frame - keyword end) in ms, and misses.

Both engines take the route ``ops.serving.forward_route`` gives the
loaded model (``use_fused=None``, as ``bin/serve`` builds its engine):
the fused kernel on the card for MDTC, DS-TCN and FSMN, the modules on
the CPU.  The JAX tool runs its engines' module route (ROADMAP C.36).

Usage:
  python -m wekws_tpu_torch.tools.bench_serving_slo \\
      --config exp/.../config.yaml --checkpoint exp/.../avg_5.pt \\
      --tokens dict/dict.txt --keyword 123 \\
      [--mode latency|detection|both] [--device cuda|cpu]
Prints one JSON line per configuration.
"""

import argparse
import json
import time

import numpy as np

SR = 16000


def pct(vals, q):
    return float(np.percentile(np.asarray(vals), q))


def bench_latency(args):
    from wekws_tpu_torch.runtime.batch_spotter import BatchKeywordSpotter

    for streams in args.streams:
        spotter = BatchKeywordSpotter(
            args.checkpoint, args.config, args.tokens, args.lexicon,
            threshold=args.threshold, num_streams=streams,
            step_frames=args.chunk, device_decode=args.device_decode,
            device_frontend=args.device_frontend, use_fused=None,
            device=args.device,
        )
        spotter.set_keywords(args.keyword)
        rng = np.random.default_rng(0)
        # one chunk of new audio per stream per iteration: the
        # steady-state real-time flow
        chunk_samples = args.chunk * 160
        pcm = [
            (rng.standard_normal(chunk_samples) * 500)
            .astype(np.int16).tobytes()
            for _ in range(8)
        ]
        # prime the 400-sample frontend window, then warm the step
        for s in range(streams):
            spotter.accept_wave(
                s, (rng.standard_normal(800) * 500)
                .astype(np.int16).tobytes())
        for i in range(args.warmup):
            for s in range(streams):
                spotter.accept_wave(s, pcm[(s + i) % len(pcm)])
            spotter.step()
        lat_step, lat_idle = [], []
        t_all0 = time.perf_counter()
        for i in range(args.iters):
            # per-chunk service time as a serving client sees it:
            # feature push + batched step + decode
            t0 = time.perf_counter()
            for s in range(streams):
                spotter.accept_wave(s, pcm[(s + i) % len(pcm)])
            ran = spotter.step()
            dt = (time.perf_counter() - t0) * 1e3
            (lat_step if ran else lat_idle).append(dt)
        wall = time.perf_counter() - t_all0
        chunk_ms = args.chunk * 10.0
        audio_s = args.iters * streams * chunk_ms / 1e3
        out = {
            "bench": "per_chunk_latency",
            "streams": streams,
            "chunk_frames": args.chunk,
            "device_decode": bool(args.device_decode),
            "device_frontend": bool(args.device_frontend),
            "chunks": args.iters,
            "step_chunks": len(lat_step),
            "realtime_factor": round(audio_s / wall, 1),
        }
        if lat_step:
            out.update({
                "step_p50_ms": round(pct(lat_step, 50), 3),
                "step_p95_ms": round(pct(lat_step, 95), 3),
                "step_p99_ms": round(pct(lat_step, 99), 3),
            })
        if lat_idle:
            out["buffer_p50_ms"] = round(pct(lat_idle, 50), 3)
        print(json.dumps(out), flush=True)


def synth_keyword_utt(rng, tones, keyword, lead_s, total_s):
    """Background noise with the keyword tone sequence starting at
    ``lead_s``; returns (wave int16, keyword_end_sample)."""
    n = int(SR * total_s)
    w = 0.02 * rng.standard_normal(n)
    pos = int(SR * lead_s)
    for ch in keyword:
        f = tones[ch] * (1 + 0.02 * rng.standard_normal())
        d = int(SR * (0.16 + 0.04 * rng.random()))
        a = 0.25 + 0.1 * rng.random()
        seg = a * np.sin(2 * np.pi * f * np.arange(d) / SR)
        w[pos:pos + d] += seg
        pos += d + int(SR * 0.02 * rng.random())
    return (
        np.clip(w * 32768.0, -32768, 32767).astype(np.int16),
        pos,
    )


def bench_detection(args):
    from wekws_tpu_torch.runtime.keyword_spotter import KeyWordSpotter

    spotter = KeyWordSpotter(
        args.checkpoint, args.config, args.tokens, args.lexicon,
        threshold=args.threshold, use_fused=None, device=args.device,
    )
    spotter.set_keywords(args.keyword)
    tones = {}
    for part in args.tones.split(","):
        k, v = part.split(":")
        tones[k] = float(v)
    rng = np.random.default_rng(7)
    chunk_bytes = int(SR * args.chunk_ms / 1000) * 2
    latencies, misses, diags = [], 0, []
    resolution_ms = spotter.resolution * 1000.0
    for utt in range(args.utts):
        wave, kw_end = synth_keyword_utt(
            rng, tones, args.keyword,
            lead_s=0.5 + 1.5 * rng.random(), total_s=4.0,
        )
        spotter.reset_all()
        pcm = wave.tobytes()
        detected = False
        for off in range(0, len(pcm), chunk_bytes):
            r = spotter.forward(pcm[off:off + chunk_bytes])
            if r.get("state") == 1:
                act_ms = (
                    spotter.detector.activation_frame * resolution_ms
                )
                lat = act_ms - kw_end / SR * 1000.0
                latencies.append(lat)
                # the tail's attribution: the frames of the winning
                # hypothesis (posterior timing, not service time)
                diags.append({
                    "utt": utt, "latency_ms": round(lat, 1),
                    "latency_frames": round(lat / resolution_ms, 2),
                    "kw_end_ms": round(kw_end / SR * 1000.0, 1),
                    "act_frame": int(spotter.detector.activation_frame),
                    "hit_score": round(float(r.get("score", 0.0)), 4),
                })
                detected = True
                break
        if not detected:
            misses += 1
    out = {
        "bench": "detection_latency",
        "keyword": args.keyword,
        "utts": args.utts,
        "missed": misses,
        "chunk_ms": args.chunk_ms,
    }
    if latencies:
        out.update({
            "p50_ms": round(pct(latencies, 50), 1),
            "p95_ms": round(pct(latencies, 95), 1),
            "p99_ms": round(pct(latencies, 99), 1),
            "min_ms": round(min(latencies), 1),
            "max_ms": round(max(latencies), 1),
            "resolution_ms": round(resolution_ms, 1),
        })
    print(json.dumps(out), flush=True)
    if args.dump_tail and diags:
        for d in sorted(diags, key=lambda d: -d["latency_ms"])[
                :args.dump_tail]:
            print(json.dumps({"tail": d}), flush=True)


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--tokens", required=True)
    ap.add_argument("--lexicon", default=None)
    ap.add_argument("--keyword", default="123")
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--mode", default="both",
                    choices=["latency", "detection", "both"])
    ap.add_argument("--streams", type=int, nargs="+", default=[1, 16, 64])
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per engine step (latency mode)")
    ap.add_argument("--chunk_ms", type=float, default=100.0,
                    help="PCM chunk size (detection mode)")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--utts", type=int, default=50)
    ap.add_argument("--device_decode", action="store_true")
    ap.add_argument("--device_frontend", action="store_true")
    ap.add_argument("--dump_tail", type=int, default=0,
                    help="print the N worst detection-latency utterances")
    ap.add_argument(
        "--tones", default="1:500,2:800,3:1150,4:1500",
        help="token:frequency map for keyword synthesis (detection "
             "mode); default matches examples/synthetic_ctc "
             "local/gen_data_torch.py TONES")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from wekws_tpu_torch.device import resolve_device

    args = get_args(argv)
    args.device = resolve_device(args.device)
    if args.mode in ("latency", "both"):
        bench_latency(args)
    if args.mode in ("detection", "both"):
        bench_detection(args)


if __name__ == "__main__":
    main()
