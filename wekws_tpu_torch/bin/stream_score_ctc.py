"""Streaming-simulation CTC scoring CLI.

Port of wekws_tpu/bin/stream_score_ctc.py (the reference wekws's
bin/stream_score_ctc.py): each test utterance, in ``--chunk_ms`` PCM
chunks, through the single-stream engine (``KeyWordSpotter``, state
reset per utterance), writing detected/rejected lines for
compute_det_ctc.  The engine picks its route (``use_fused=None``,
``runtime.keyword_spotter.use_fused_stream``): on the card the fused
serving kernel for a model that has one (``fused_fsmn_kernel`` for
FSMN), else and on the CPU the module; an exported artifact directory
(float or static int8) steps the artifact runtime on either
(export/torch_runtime.py).
"""

import argparse
import json
import logging


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="streaming ctc scoring")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a port .pt, a JAX-package .ckpt, or an exported "
                             "artifact directory (model.json + "
                             "weights[_int8].bin) to serve a float or "
                             "static-int8 artifact on the device")
    parser.add_argument("--test_data", required=True)
    parser.add_argument("--token_file", required=True)
    parser.add_argument("--lexicon_file", default=None)
    parser.add_argument("--keywords", required=True)
    parser.add_argument("--score_file", required=True)
    parser.add_argument("--threshold", type=float, default=0.0)
    parser.add_argument("--min_frames", type=int, default=5)
    parser.add_argument("--max_frames", type=int, default=250)
    parser.add_argument("--interval_frames", type=int, default=50)
    parser.add_argument("--chunk_ms", type=int, default=300)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
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
        args.interval_frames, use_fused=None, device=device,
    )
    spotter.set_keywords(args.keywords)

    n = 0
    with open(args.test_data, encoding="utf8") as fin, open(
        args.score_file, "w", encoding="utf8"
    ) as fout:
        for line in fin:
            if not line.strip():
                continue
            obj = json.loads(line)
            key = obj["key"]
            spotter.reset_all()
            wave, sr = read_wav(obj["wav"])
            pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
            chunk_bytes = 2 * int(sr * args.chunk_ms / 1000)
            hit = None
            for off in range(0, len(pcm), chunk_bytes):
                result = spotter.forward(pcm[off : off + chunk_bytes])
                if result and result.get("state") == 1:
                    hit = result
                    break
            if hit is not None:
                fout.write(
                    f"{key} detected {hit['keyword']} {hit['score']:.3f}\n"
                )
            else:
                fout.write(f"{key} rejected\n")
            n += 1
    return n


if __name__ == "__main__":
    main()
