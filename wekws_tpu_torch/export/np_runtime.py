"""Numpy interpreter for exported graph artifacts.

The port's copy of wekws_tpu/export/np_runtime.py: the executable
specification of the C++ streaming runtime (runtime/ — same op
semantics, same cache layout), and the export parity gate of
``bin/export_model``: the artifact run here must match the port
model's float32 forward (tests/test_torch_export.py), and the device
runtime (export/torch_runtime.py) is held against it.

State: per-cache-slot left-context arrays (len, dim) (GRU: hidden
state).  forward(feats, state) processes a (T, D) chunk and returns
(output, new_state); chunked calls equal one full-utterance call.
``forward``'s ``acc_observer(op_index, key, acc)`` sees every int8
op's zero-point-shifted int32 accumulator (per weight ``key``), the
numbers ``TorchGraphRuntime`` is held to exactly.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from wekws_tpu_torch.export.graph import load_any


def _act(x: np.ndarray, act: str) -> np.ndarray:
    if act == "relu":
        return np.maximum(x, 0.0)
    if act == "sigmoid":
        return 1.0 / (1.0 + np.exp(-x))
    return x


def _quantize_shifted(x: np.ndarray, scale: float, zp: int) -> np.ndarray:
    """f32 -> zero-point-shifted int32: clamp(rint(x/s) + zp) - zp.

    All arithmetic stays in float32 and rint rounds half-to-even,
    matching the C++ runtime (float division + std::nearbyint under
    the default FE_TONEAREST mode) so the two int8 paths agree."""
    q = np.clip(
        np.rint(x / np.float32(scale)) + np.int32(zp), -128, 127
    ).astype(np.int32)
    return q - np.int32(zp)


class GraphRuntime:
    def __init__(self, model_dir: str):
        self.artifact, self._flat, self._int8 = load_any(model_dir)
        self.ops = self.artifact["ops"]
        self.caches = self.artifact["caches"]
        self.meta = self.artifact["meta"]

    def qtensor(self, ref: Dict):
        """Raw (int8 weights, per-channel scales) for int8 execution."""
        qr, sr = ref["int8"], ref["scale"]
        size = int(np.prod(qr["shape"]))
        q = self._int8[qr["offset"] : qr["offset"] + size].reshape(
            qr["shape"]
        )
        scale = self._flat[
            sr["offset"] : sr["offset"] + int(np.prod(sr["shape"]))
        ].reshape(sr["shape"])
        return q, scale

    def tensor(self, ref: Dict) -> np.ndarray:
        if "int8" in ref:  # quantized: dequantize per output channel
            q, scale = self.qtensor(ref)
            return q.astype(np.float32) * scale
        size = int(np.prod(ref["shape"])) if ref["shape"] else 1
        return self._flat[ref["offset"] : ref["offset"] + size].reshape(
            ref["shape"]
        )

    def init_state(self) -> List[np.ndarray]:
        return [
            np.zeros((c["len"], c["dim"]), np.float32) for c in self.caches
        ]

    def forward(
        self,
        feats: np.ndarray,
        state: Optional[List[np.ndarray]] = None,
        observer=None,
        acc_observer=None,
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """``observer(buf_id, array)`` is called for the input buffer
        and every produced buffer — the calibration hook
        (export/calibrate.py); ``acc_observer(op_index, key, acc)``
        for every int8 accumulator."""
        seen = acc_observer or (lambda *args: None)
        if state is None:
            state = self.init_state()
        state = list(state)
        bufs: Dict[int, np.ndarray] = {0: np.asarray(feats, np.float32)}
        if observer is not None:
            observer(0, bufs[0])
        for i, entry in enumerate(self.ops):
            op = entry["op"]
            attrs = entry.get("attrs", {})
            x = bufs[entry["inputs"][0]]
            int8_exec = "in_scale" in attrs and "int8" in entry.get("W", {})
            if op == "cmvn":
                y = (x - self.tensor(entry["mean"])) * self.tensor(
                    entry["istd"]
                )
            elif op == "dense":
                if int8_exec:
                    q, wsc = self.qtensor(entry["W"])
                    s = float(attrs["in_scale"])
                    xq = _quantize_shifted(x, s, int(attrs["in_zp"]))
                    acc = xq @ q.astype(np.int32)
                    seen(i, "W", acc)
                    y = acc.astype(np.float32) * (np.float32(s) * wsc)
                else:
                    y = x @ self.tensor(entry["W"])
                if "b_" in entry:
                    y = y + self.tensor(entry["b_"])
                y = _act(y, attrs.get("act", "none"))
            elif op in ("conv", "dw_conv"):
                cid = attrs["cache"]
                dilation = attrs["dilation"]
                if int8_exec:
                    q, wsc = self.qtensor(entry["W"])
                    k = q.shape[0]
                else:
                    w = self.tensor(entry["W"])
                    k = w.shape[0]
                pad = (k - 1) * dilation
                ext = np.concatenate([state[cid], x], axis=0)
                state[cid] = ext[len(ext) - pad :].copy() if pad else ext[:0]
                t_out = len(ext) - pad
                if int8_exec:
                    s = float(attrs["in_scale"])
                    xq = _quantize_shifted(ext, s, int(attrs["in_zp"]))
                    qi = q.astype(np.int32)
                    if op == "dw_conv":
                        acc = np.zeros((t_out, q.shape[1]), np.int32)
                        for tap in range(k):
                            acc += (
                                xq[tap * dilation : tap * dilation + t_out]
                                * qi[tap]
                            )
                    else:
                        acc = np.zeros((t_out, q.shape[2]), np.int32)
                        for tap in range(k):
                            acc += (
                                xq[tap * dilation : tap * dilation + t_out]
                                @ qi[tap]
                            )
                    seen(i, "W", acc)
                    y = acc.astype(np.float32) * (np.float32(s) * wsc)
                elif op == "dw_conv":
                    c = w.shape[1]
                    y = np.zeros((t_out, c), np.float32)
                    for tap in range(k):
                        y += ext[tap * dilation : tap * dilation + t_out] \
                            * w[tap]
                else:
                    cout = w.shape[2]
                    y = np.zeros((t_out, cout), np.float32)
                    for tap in range(k):
                        y += ext[tap * dilation : tap * dilation + t_out] \
                            @ w[tap]
                if "b_" in entry:
                    y = y + self.tensor(entry["b_"])
                y = _act(y, attrs.get("act", "none"))
            elif op == "fsmn_block":
                y = self._fsmn_block(entry, attrs, x, state,
                                     lambda key, a, i=i: seen(i, key, a))
            elif op == "gru":
                y = self._gru(entry, attrs, x, state)
            elif op == "add":
                y = x + bufs[entry["inputs"][1]]
            elif op == "relu":
                y = np.maximum(x, 0.0)
            elif op == "sigmoid":
                y = 1.0 / (1.0 + np.exp(-x))
            elif op == "softmax":
                e = np.exp(x - x.max(axis=-1, keepdims=True))
                y = e / e.sum(axis=-1, keepdims=True)
            elif op == "mean_pool":
                y = x.mean(axis=0, keepdims=True)
            elif op == "last_frame":
                y = x[-1:, :]
            else:
                raise ValueError(f"unknown op {op}")
            bufs[entry["out"]] = y
            if observer is not None:
                observer(entry["out"], y)
        return bufs[self.meta["output"]], state

    def _fsmn_block(self, entry, attrs, x, state, seen):
        lorder = attrs["lorder"]
        rorder = attrs["rorder"]
        lstride = attrs["lstride"]
        rstride = attrs["rstride"]
        cid = attrs["cache"]
        pad = (lorder - 1) * lstride + rorder * rstride
        ext = np.concatenate([state[cid], x], axis=0)
        state[cid] = ext[len(ext) - pad :].copy() if pad else ext[:0]
        t_out = len(ext) - pad
        rspan = rorder * rstride
        # identity path aligned with the (rorder-delayed) output —
        # stays exact f32 even on the int8 path (implicit weight 1.0
        # has no per-channel scale)
        start = (lorder - 1) * lstride
        y = ext[start : start + t_out].copy()
        int8_exec = "in_scale" in attrs and "int8" in entry.get("Wl", {})
        if int8_exec:
            s = float(attrs["in_scale"])
            xq = _quantize_shifted(ext, s, int(attrs["in_zp"]))
            ql, wlsc = self.qtensor(entry["Wl"])
            qli = ql.astype(np.int32)
            acc = np.zeros((t_out, ext.shape[1]), np.int32)
            for tap in range(lorder):
                acc += xq[tap * lstride : tap * lstride + t_out] * qli[tap]
            seen("Wl", acc)
            y = y + acc.astype(np.float32) * (np.float32(s) * wlsc)
            if "Wr" in entry and rorder > 0:
                qr, wrsc = self.qtensor(entry["Wr"])
                qri = qr.astype(np.int32)
                accr = np.zeros((t_out, ext.shape[1]), np.int32)
                base = len(ext) - (t_out + rspan) + rstride
                for tap in range(rorder):
                    o = base + tap * rstride
                    accr += xq[o : o + t_out] * qri[tap]
                seen("Wr", accr)
                y = y + accr.astype(np.float32) * (np.float32(s) * wrsc)
            return y
        wl = self.tensor(entry["Wl"])  # (lorder, C)
        wr = self.tensor(entry["Wr"]) if "Wr" in entry else None
        # left taps over ext[:-rspan]
        for tap in range(lorder):
            y += ext[tap * lstride : tap * lstride + t_out] * wl[tap]
        if wr is not None and rorder > 0:
            base = len(ext) - (t_out + rspan) + rstride
            for tap in range(rorder):
                o = base + tap * rstride
                y += ext[o : o + t_out] * wr[tap]
        return y

    def _gru(self, entry, attrs, x, state):
        cid = attrs["cache"]
        h = state[cid][0]  # (H,)
        wih = self.tensor(entry["Wih"])
        bih = self.tensor(entry["bih"])
        whh = self.tensor(entry["Whh"])
        bhh = self.tensor(entry["bhh"])
        hdim = attrs["hidden"]
        out = np.zeros((len(x), hdim), np.float32)
        for t in range(len(x)):
            gi = x[t] @ wih + bih
            gh = h @ whh + bhh
            xr, xz, xn = np.split(gi, 3)
            hr, hz, hn = np.split(gh, 3)
            r = 1.0 / (1.0 + np.exp(-(xr + hr)))
            z = 1.0 / (1.0 + np.exp(-(xz + hz)))
            n = np.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            out[t] = h
        state[cid] = h[None, :].copy()
        return out
