"""Post-training int8 quantization CLI.

Port of wekws_tpu/bin/static_quantize.py over the graph-artifact path.
With ``--calib_data`` (a data.list) it performs static quantization:
activation ranges are observed over the calibration set (the port's
``StreamingFrontend`` features, export/calibrate.py) and the artifact
executes dense/conv/dw_conv/fsmn_block ops in int8 in every runtime.
Without it, weights-only quantization (storage shrink, float compute)
is applied.  The max posterior deviation (float artifact against the
quantized one, on the calibration features or, without them, on
``default_rng(0)`` normal features) is read from ``TorchGraphRuntime``
on ``--device`` (the card by default), the runtime that serves it.

    python -m wekws_tpu_torch.bin.static_quantize --model_dir exp/export \\
        --output_dir exp/export_int8 --calib_data data/dev.list
"""

import argparse
import json

import numpy as np


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="static quantization")
    parser.add_argument("--model_dir", required=True,
                        help="exported graph artifact dir")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--calib_data", default=None,
                        help="data.list for activation calibration "
                             "(reference uses the test set)")
    parser.add_argument("--num_calib", type=int, default=100,
                        help="max calibration utterances")
    parser.add_argument("--percentile", type=float, default=None,
                        help="range percentile (default: min/max)")
    parser.add_argument("--device", default="cuda",
                        help="where the deviation is read: cuda (default) "
                             "or cpu")
    return parser.parse_args(argv)


def read_calibration_waves(calib_data: str, num_calib: int):
    """Up to ``num_calib`` int16-scale waves of a data.list; unreadable
    wavs are reported and skipped, none readable raises."""
    from wekws_tpu_torch.data.audio import read_wav

    waves, failed = [], 0
    with open(calib_data, encoding="utf8") as f:
        for line in f:
            if len(waves) >= num_calib:
                break
            obj = json.loads(line)
            try:
                wave, _sr = read_wav(obj["wav"])
            except (OSError, ValueError) as e:
                failed += 1
                if failed <= 5:
                    print(f"warning: cannot read {obj.get('wav')}: {e}")
                continue
            waves.append(wave * 32768.0)
    if failed:
        print(f"warning: {failed} calibration wavs unreadable")
    if not waves:
        raise SystemExit(
            f"no readable calibration audio in {calib_data} "
            f"({failed} failures) — check the wav paths"
        )
    return waves


def main(argv=None):
    """Returns the max posterior deviation."""
    args = get_args(argv)
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.export import TorchGraphRuntime
    from wekws_tpu_torch.export.calibrate import feats_from_waves
    from wekws_tpu_torch.export.quantize import quantize_artifact

    device = resolve_device(args.device)
    calib_feats = None
    if args.calib_data:
        waves = read_calibration_waves(args.calib_data, args.num_calib)
        calib_feats = feats_from_waves(args.model_dir, waves)
        print(f"calibrated over {len(calib_feats)} utterances")

    quantize_artifact(args.model_dir, args.output_dir,
                      calib_feats=calib_feats,
                      percentile=args.percentile)

    f32 = TorchGraphRuntime(args.model_dir, device)
    q = TorchGraphRuntime(args.output_dir, device)
    if calib_feats:
        probes = calib_feats[: min(10, len(calib_feats))]
    else:
        in_dim = f32.meta["model_conf"]["input_dim"]
        rng = np.random.default_rng(0)
        probes = [rng.standard_normal((200, in_dim)).astype(np.float32)]
    err = 0.0
    for probe in probes:
        a, _ = f32.forward(probe)
        b, _ = q.forward(probe)
        err = max(err, float((a - b).abs().max()))
    mode = "static int8 execution" if calib_feats else "weights-only"
    print(f"quantized ({mode}) -> {args.output_dir}; "
          f"max posterior deviation {err:.4f} ({device.type} runtime)")
    return err


if __name__ == "__main__":
    main()
