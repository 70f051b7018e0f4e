"""Post-training int8 quantization of graph artifacts.

The port's copy of wekws_tpu/export/quantize.py (the same files, byte
for byte, from the same artifact and calibration features).  Analog of
the reference wekws's eager-mode static PTQ
(bin/static_quantize.py:57-130 there): weights of every
matmul-like op are quantized to symmetric per-output-channel int8
(stored in ``weights_int8.bin`` + float scales in ``weights.bin``),
shrinking the artifact ~4x.  The runtime dequantizes on load (or runs
int8 kernels natively); quantization error is checked by the same
parity machinery as export.
"""

import json
import os
from typing import Dict, List

import numpy as np

from wekws_tpu_torch.export.graph import load_artifact, write_text_format

_QUANT_KEYS = ("W", "Wl", "Wr", "Wih", "Whh")


def quantize_artifact(
    model_dir: str,
    out_dir: str,
    calib_feats=None,
    percentile=None,
) -> dict:
    """Weight-only PTQ, or full static PTQ when ``calib_feats`` (an
    iterable of (T, D) feature matrices) is given.

    Static mode runs the float artifact over the calibration set with
    range observers (export/calibrate.py — the analog of the
    reference's torch.quantization.prepare + observer pass,
    static_quantize.py:57-130), then stamps every dense/conv/dw_conv
    with its input activation's (scale, zero_point).  Both runtimes
    (np_runtime.py and the C++ graph_model.cc) execute those ops in
    int8: activations quantize at the op boundary, the dot products
    accumulate in int32, and the result dequantizes through
    in_scale * weight_scale[channel].  fsmn_block taps execute in int8
    too (the identity path stays exact f32 — implicit weight 1.0 has
    no channel scale); gru stays float compute with int8-stored
    weights (its inter-gate sigmoids make static activation quant
    impractical — the reference's fbgemm path also leaves RNNs in
    float)."""
    artifact, flat = load_artifact(model_dir)
    qparams = None
    if calib_feats is not None:
        from wekws_tpu_torch.export.calibrate import (
            calibrate_activation_ranges,
        )

        qparams = calibrate_activation_ranges(
            model_dir, calib_feats, percentile
        )
    new_f32: List[np.ndarray] = []
    new_i8: List[np.ndarray] = []
    f32_off = 0
    i8_off = 0

    def take(ref: Dict) -> np.ndarray:
        size = int(np.prod(ref["shape"])) if ref["shape"] else 1
        return flat[ref["offset"] : ref["offset"] + size].reshape(
            ref["shape"]
        )

    def put_f32(arr: np.ndarray) -> Dict:
        nonlocal f32_off
        arr = np.ascontiguousarray(arr.astype(np.float32))
        ref = {"offset": int(f32_off), "shape": list(arr.shape)}
        new_f32.append(arr)
        f32_off += arr.size
        return ref

    def put_i8(arr: np.ndarray) -> Dict:
        nonlocal i8_off
        arr = np.ascontiguousarray(arr.astype(np.int8))
        ref = {"offset": int(i8_off), "shape": list(arr.shape)}
        new_i8.append(arr)
        i8_off += arr.size
        return ref

    for entry in artifact["ops"]:
        for key in list(entry.keys()):
            if key in _QUANT_KEYS and isinstance(entry[key], dict):
                w = take(entry[key])
                # per-output-channel (last axis) symmetric scales
                absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
                scale = np.maximum(absmax, 1e-12) / 127.0
                q = np.clip(np.round(w / scale), -127, 127)
                entry[key] = {
                    "int8": put_i8(q),
                    "scale": put_f32(scale),
                }
            elif isinstance(entry.get(key), dict) and "offset" in entry[key]:
                # non-quantized weight (biases, cmvn, ...): re-pack
                entry[key] = put_f32(take(entry[key]))
        if (
            qparams is not None
            and entry["op"] in ("dense", "conv", "dw_conv", "fsmn_block")
            and entry["inputs"][0] in qparams
        ):
            s, zp = qparams[entry["inputs"][0]]
            attrs = entry.setdefault("attrs", {})
            attrs["in_scale"] = float(s)
            attrs["in_zp"] = int(zp)

    artifact["meta"]["quantized"] = True
    artifact["meta"]["static_quant"] = qparams is not None
    os.makedirs(out_dir, exist_ok=True)
    f32 = (np.concatenate([a.reshape(-1) for a in new_f32])
           if new_f32 else np.zeros((0,), np.float32))
    i8 = (np.concatenate([a.reshape(-1) for a in new_i8])
          if new_i8 else np.zeros((0,), np.int8))
    f32.astype("<f4").tofile(os.path.join(out_dir, "weights.bin"))
    i8.tofile(os.path.join(out_dir, "weights_int8.bin"))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(artifact, f)
    write_text_format(artifact, os.path.join(out_dir, "model.txt"))
    return artifact


def load_quantized(model_dir: str):
    """-> (artifact, f32 weights, int8 weights)."""
    with open(os.path.join(model_dir, "model.json")) as f:
        artifact = json.load(f)
    f32 = np.fromfile(os.path.join(model_dir, "weights.bin"), dtype="<f4")
    i8 = np.fromfile(
        os.path.join(model_dir, "weights_int8.bin"), dtype=np.int8
    )
    return artifact, f32, i8
