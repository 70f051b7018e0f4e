"""KWS serving daemon CLI.

Port of wekws_tpu/bin/serve.py: the batched multi-stream engine (CTC
beams, optionally decoded on the device, or max-pooling threshold
detection) behind the framed-TCP protocol of serving/protocol.py, so
that many network clients share one batched device step.

    python -m wekws_tpu_torch.bin.serve \\
        --config exp/config.yaml --checkpoint exp/avg_5.ckpt \\
        --token_file tokens.txt --keywords "hi xiaowen" \\
        --port 8990 --streams 64 [--device_decode] [--warmup]

    python -m wekws_tpu_torch.bin.serve --maxpool \\
        --config exp/config.yaml --checkpoint exp/avg_5.ckpt \\
        --threshold 0.5 --keywords wake --streams 64

Client side: ``wekws_tpu_torch.serving.KwsClient``.  On the card the
engine's route comes from ``ops.serving.forward_route`` for the loaded
model: the fused serving kernel for MDTC, DS-TCN and FSMN, the modules
for GRU and full-conv TCN; an exported artifact directory (float or
static int8) as ``--checkpoint`` serves through the artifact runtime
(export/torch_runtime.py).  ``--mesh_devices N`` splits the streams
over the first N cards in equal row blocks (more cards than the machine
has raises: ROADMAP C.21); the JAX CLI's ``--compilation_cache_dir``
(an XLA cache) has no counterpart.

SIGTERM or SIGINT stops the daemon; its last log line is ``served:``
and a JSON object: the engine's step stats, the server's, and each
serving kernel's launches since the port opened (``launches``).
"""

import argparse
import asyncio
import json
import logging
import signal
import time


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="kws serving daemon")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a port .pt, a JAX-package .ckpt, or an exported "
                             "artifact directory (model.json + "
                             "weights[_int8].bin) to serve a float or "
                             "static-int8 artifact on the device")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8990,
                        help="0 picks a free port (logged at start)")
    parser.add_argument("--streams", type=int, default=16)
    parser.add_argument("--step_frames", type=int, default=8)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--maxpool", action="store_true",
                        help="max-pooling (sigmoid) model: threshold + "
                             "refractory detection instead of CTC beams")
    parser.add_argument("--token_file", default=None)
    parser.add_argument("--lexicon_file", default=None)
    parser.add_argument("--keywords", default=None)
    parser.add_argument("--min_frames", type=int, default=5)
    parser.add_argument("--max_frames", type=int, default=250)
    parser.add_argument("--interval_frames", type=int, default=50)
    parser.add_argument("--score_beam", type=int, default=3)
    parser.add_argument("--path_beam", type=int, default=20)
    parser.add_argument("--device_decode", action="store_true")
    parser.add_argument("--device_frontend", action="store_true",
                        help="featurize inside the batched device step "
                             "(features + splice + skip); the host only "
                             "buffers raw samples per stream")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="split the streams over the first N cards "
                             "(equal row blocks; more than the machine "
                             "has raises)")
    parser.add_argument("--warmup", action="store_true",
                        help="build the kernels and run one step and one "
                             "flush before the port opens")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def warmup_engine(engine):
    """One full step + tail flush on slot 0: the first launches build
    and load every kernel of the serving step (and, for a full step and
    a padded flush, one shape each).  Feeds silence until just past one
    step's worth of FEATURE frames (the frontend may splice and skip,
    so samples->frames is not static arithmetic).  Stream state AND
    step stats are cleared afterwards, so the build does not skew later
    stats readouts."""
    cfg = engine._frontend_args[0]
    chunk = bytes(
        2 * (cfg.frame_length + engine.step_frames * cfg.frame_shift)
    )
    while engine.pending_frames(0) <= engine.step_frames:
        engine.accept_wave(0, chunk)
    engine.step()
    engine.flush_stream(0)
    engine.reset_all()
    engine.stats = {k: type(v)() for k, v in engine.stats.items()}


def build_engine(args):
    """The engine an argparse Namespace of ``get_args`` describes."""
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.parallel.mesh import mesh_devices
    from wekws_tpu_torch.runtime import (
        BatchKeywordSpotter,
        BatchMaxPoolSpotter,
    )

    device = resolve_device(args.device)
    if args.mesh_devices:
        device = mesh_devices(args.mesh_devices, device)
    if args.maxpool:
        names = args.keywords.split(",") if args.keywords else None
        return BatchMaxPoolSpotter(
            args.checkpoint, args.config, args.threshold,
            num_streams=args.streams, step_frames=args.step_frames,
            interval_frames=args.interval_frames, keyword_names=names,
            use_fused=None, device_frontend=args.device_frontend,
            device=device,
        )
    if not args.token_file or not args.keywords:
        raise SystemExit(
            "--token_file and --keywords are required in CTC mode"
        )
    engine = BatchKeywordSpotter(
        args.checkpoint, args.config, args.token_file, args.lexicon_file,
        args.threshold, num_streams=args.streams,
        step_frames=args.step_frames, min_frames=args.min_frames,
        max_frames=args.max_frames, interval_frames=args.interval_frames,
        score_beam=args.score_beam, path_beam=args.path_beam,
        device_decode=args.device_decode,
        device_frontend=args.device_frontend, use_fused=None,
        device=device,
    )
    engine.set_keywords(args.keywords)
    return engine


async def serve_until_signal(server) -> None:
    """Serve until SIGTERM or SIGINT, then stop the server."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await server.start()
    await stop.wait()
    await server.stop()


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    from wekws_tpu_torch.ops.serving import launch_counts
    from wekws_tpu_torch.serving import KwsServer

    engine = build_engine(args)
    if args.warmup:
        logging.info("warmup: building the kernels, one step and a flush")
        t0 = time.perf_counter()
        warmup_engine(engine)
        logging.info("warmup done in %.1fs", time.perf_counter() - t0)
    server = KwsServer(engine, args.host, args.port)
    before = launch_counts()
    asyncio.run(serve_until_signal(server))
    after = launch_counts()
    logging.info("served: %s", json.dumps({
        "engine": engine.stats, "server": server.stats,
        "launches": {k: after[k] - before[k] for k in after}}))


if __name__ == "__main__":
    main()
