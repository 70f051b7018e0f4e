"""Streaming KWS demo CLI: feed a wav file chunk by chunk.

Port of wekws_tpu/bin/stream_kws_ctc.py: simulates real-time streaming
with ``--chunk_ms`` PCM chunks through the single-stream engine
(``KeyWordSpotter``).  On the card the engine's route comes from
``ops.serving.forward_route`` (``fused_fsmn_kernel`` for an FSMN).
"""

import argparse
import logging


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="streaming kws")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--token_file", required=True)
    parser.add_argument("--lexicon_file", default=None)
    parser.add_argument("--keywords", required=True)
    parser.add_argument("--wav_path", required=True)
    parser.add_argument("--threshold", type=float, default=0.02)
    parser.add_argument("--min_frames", type=int, default=5)
    parser.add_argument("--max_frames", type=int, default=250)
    parser.add_argument("--interval_frames", type=int, default=50)
    parser.add_argument("--score_beam", type=int, default=3)
    parser.add_argument("--path_beam", type=int, default=20)
    parser.add_argument("--chunk_ms", type=int, default=300)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the detections, the result dicts with state 1, in
    order."""
    args = get_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    import numpy as np

    from wekws_tpu_torch.data.audio import read_wav
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.runtime import KeyWordSpotter

    device = resolve_device(args.device)
    spotter = KeyWordSpotter(
        args.checkpoint, args.config, args.token_file, args.lexicon_file,
        args.threshold, args.min_frames, args.max_frames,
        args.interval_frames, args.score_beam, args.path_beam,
        use_fused=None,
        device=device,
    )
    spotter.set_keywords(args.keywords)

    wave, sr = read_wav(args.wav_path)
    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    chunk_bytes = 2 * int(sr * args.chunk_ms / 1000)
    detections = []
    for off in range(0, len(pcm), chunk_bytes):
        result = spotter.forward(pcm[off:off + chunk_bytes])
        if result and result.get("state") == 1:
            detections.append(result)
            print(
                f"detect {result['keyword']} from {result['start']:.2f}s "
                f"to {result['end']:.2f}s score {result['score']:.3f}"
            )
    return detections


if __name__ == "__main__":
    main()
