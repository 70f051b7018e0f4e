"""PyTorch executor for exported graph artifacts, batched over streams.

The port's counterpart of wekws_tpu/export/jax_runtime.py: the same op
semantics and cache layout as the numpy interpreter
(export/np_runtime.py) and the C++ graph runtime, run eagerly on
``device`` (the card unless the caller asks for the CPU) over ``(B, T,
D)`` features, with state a list of ``(B, len, dim)`` caches; chunked
calls equal one full-utterance call.  The weights are staged on the
device once, at construction, and every op runs there.

Static int8 (an artifact from ``quantize_artifact`` with calibration):

* activations quantize at each int8 op's boundary with the calibrated
  ``(in_scale, in_zp)``: ``clamp(round(x / s) + zp, -128, 127)``, the
  division by a float32 device tensor (a CPU scalar would make CUDA
  multiply by the reciprocal) and round half to even, as the numpy and
  C++ paths quantize;
* the matrix products of ``dense`` and each ``conv`` tap contract the
  UNSHIFTED quantized activations with the int8 weights and fold the
  zero point in afterwards as ``acc - zp * colsum(W)`` (an exact
  integer identity), as the JAX runtime does with an int8 x int8 ->
  int32 ``dot_general``.  PyTorch has no integer matmul on CUDA, so the
  product is a float32 ``matmul`` of the integer-valued operands, cast
  to int32: exact while every partial sum stays an integer of at most
  2**24, i.e. for a contraction of K <= 1,032 (K * 128 * 127 <= 2**24),
  in TF32 too (an 8-bit integer is exact in TF32's mantissa and the
  tensor cores accumulate in float32).  An int8 op with a wider
  contraction raises at construction (``EXACT_K``).  The int8 tensor
  cores are later speed work (ROADMAP B.7);
* the per-tap ``dw_conv`` and ``fsmn_block`` products stay elementwise
  int32; the accumulator dequantizes as ``acc * (s * scale)`` in
  float32, in the JAX runtime's order; ``fsmn_block``'s identity path
  and every other op stay float32;
* a weight stored int8 on an op without activation scales (weights-only
  quantization, and ``gru``) is dequantized once at construction.

``ArtifactModelAdapter`` puts a runtime behind the serving engines'
model contract (``model(feats, cache, softmax=...)``, ``init_cache``),
so ``KeyWordSpotter``, the batched engines and ``bin/serve`` serve an
artifact directory, float or int8.  GRU steps frame by frame in Python,
as models/gru.py does (ROADMAP C.7).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.export.np_runtime import GraphRuntime

# the widest int8 contraction whose float32 product is exact:
# K * 128 * 127 <= 2**24
EXACT_K = (1 << 24) // (128 * 127)
_MATMUL_OPS = ("dense", "conv")


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    return x


class _QWeight:
    """An int8 weight on the device: the integer values as float32 (the
    operand of a matrix product) or int32 (of an elementwise tap
    product), per-output-channel scales, and the column sums over every
    axis but the last (the zero-point fold)."""

    def __init__(self, q: np.ndarray, scale: np.ndarray, matmul: bool,
                 dev: torch.device):
        qt = torch.as_tensor(q, device=dev)
        self.q = qt.to(torch.float32 if matmul else torch.int32)
        self.scale = torch.as_tensor(scale, device=dev)
        self.colsum = qt.to(torch.int32).sum(
            dim=tuple(range(q.ndim - 1))).to(torch.int32)


class TorchGraphRuntime:
    """Batched eager executor over a graph artifact (float or int8) on
    ``device``."""

    def __init__(self, model_dir: str, device="cuda"):
        self.device = dev = resolve_device(device)
        spec = GraphRuntime(model_dir)  # reads the files, slices weights
        self.artifact = spec.artifact
        self.ops = self.artifact["ops"]
        self.caches = self.artifact["caches"]
        self.meta = self.artifact["meta"]
        self._w: List[Dict[str, object]] = []
        self._q: List[Optional[Tuple[torch.Tensor, int]]] = []
        for i, entry in enumerate(self.ops):
            attrs = entry.get("attrs", {})
            main = "Wl" if entry["op"] == "fsmn_block" else "W"
            int8_exec = ("in_scale" in attrs
                         and "int8" in entry.get(main, {}))
            slot: Dict[str, object] = {}
            for key, ref in entry.items():
                if not isinstance(ref, dict):
                    continue
                if "int8" in ref and int8_exec and key in ("W", "Wl", "Wr"):
                    slot[key] = _QWeight(*spec.qtensor(ref),
                                         entry["op"] in _MATMUL_OPS, dev)
                elif "int8" in ref or "offset" in ref:
                    # float, or int8 dequantized once as the numpy
                    # runtime does (weights-only quantization, gru)
                    slot[key] = torch.as_tensor(spec.tensor(ref),
                                                device=dev)
            if int8_exec:
                w = slot[main]
                if entry["op"] in _MATMUL_OPS:
                    k = w.q.shape[-2]
                    if k > EXACT_K:
                        raise ValueError(
                            f"op {i} ({entry['op']}): an int8 contraction "
                            f"of K={k} exceeds {EXACT_K}, the widest whose "
                            f"float32 product of int8 operands is exact "
                            f"(K * 128 * 127 <= 2**24)")
                self._q.append((
                    torch.tensor(float(attrs["in_scale"]),
                                 dtype=torch.float32, device=dev),
                    int(attrs["in_zp"])))
            else:
                self._q.append(None)
            self._w.append(slot)

    # -- state ----------------------------------------------------------
    def init_state(self, batch: int) -> List[torch.Tensor]:
        return [
            torch.zeros((batch, c["len"], c["dim"]), dtype=torch.float32,
                        device=self.device)
            for c in self.caches
        ]

    # -- execution -------------------------------------------------------
    def _quantize(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """float32 -> the unshifted int8 values, held in float32."""
        s, zp = self._q[i]
        return torch.clamp(torch.round(x / s) + zp, -128, 127)

    def _int8_taps(self, i, key, xq, taps, dilation, t_out, seen):
        """The int32 accumulator of weight ``key`` of op ``i`` over the
        quantized ``xq``: one product (``taps=None``, dense) or a tap
        loop over W's leading axis with the given dilation or stride,
        the zero point folded; dequantized to float32."""
        s, zp = self._q[i]
        w = self._w[i][key]
        if taps is None:
            acc = torch.matmul(xq, w.q).to(torch.int32)
        else:
            acc = None
            for tap in range(taps):
                sl = xq[:, tap * dilation:tap * dilation + t_out]
                if w.q.dim() == 3:  # conv: (K, C, Cout)
                    part = torch.matmul(sl, w.q[tap]).to(torch.int32)
                else:  # dw taps: (K, C), elementwise
                    part = sl * w.q[tap]
                acc = part if acc is None else acc + part
        acc = acc - zp * w.colsum
        seen(i, key, acc)
        return acc.to(torch.float32) * (s * w.scale)

    def forward(
        self,
        feats,
        state: Optional[List[torch.Tensor]] = None,
        observer=None,
        acc_observer=None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, T, D) features (a (T, D) input is batched to B=1 and the
        output squeezed back) -> (output on the device, new state).
        ``observer(buf_id, tensor)`` sees the input and every produced
        buffer, ``acc_observer(op_index, key, acc)`` every int8 op's
        int32 accumulator (zero point folded)."""
        dev = self.device
        x = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        if state is None:
            state = self.init_state(x.shape[0])
        state = list(state)
        seen = acc_observer or (lambda *args: None)
        bufs: Dict[int, torch.Tensor] = {0: x}
        if observer is not None:
            observer(0, x)
        for i, entry in enumerate(self.ops):
            op = entry["op"]
            attrs = entry.get("attrs", {})
            w = self._w[i]
            x = bufs[entry["inputs"][0]]
            int8_exec = self._q[i] is not None
            if op == "cmvn":
                y = (x - w["mean"]) * w["istd"]
            elif op == "dense":
                if int8_exec:
                    y = self._int8_taps(i, "W", self._quantize(i, x), None,
                                        1, None, seen)
                else:
                    y = torch.matmul(x, w["W"])
                if "b_" in w:
                    y = y + w["b_"]
                y = _act(y, attrs.get("act", "none"))
            elif op in ("conv", "dw_conv"):
                cid = attrs["cache"]
                dilation = attrs["dilation"]
                k = (w["W"].q if int8_exec else w["W"]).shape[0]
                pad = (k - 1) * dilation
                ext = torch.cat([state[cid], x], dim=1)
                t_ext = ext.shape[1]
                state[cid] = ext[:, t_ext - pad:] if pad else ext[:, :0]
                t_out = t_ext - pad
                if int8_exec:
                    xq = self._quantize(i, ext)
                    if op == "dw_conv":
                        xq = xq.to(torch.int32)
                    y = self._int8_taps(i, "W", xq, k, dilation, t_out, seen)
                else:
                    y = None
                    for tap in range(k):
                        sl = ext[:, tap * dilation:tap * dilation + t_out]
                        part = (torch.matmul(sl, w["W"][tap])
                                if op == "conv" else sl * w["W"][tap])
                        y = part if y is None else y + part
                if "b_" in w:
                    y = y + w["b_"]
                y = _act(y, attrs.get("act", "none"))
            elif op == "fsmn_block":
                y = self._fsmn_block(i, attrs, x, state, seen)
            elif op == "gru":
                y = self._gru(i, attrs, x, state)
            elif op == "add":
                y = x + bufs[entry["inputs"][1]]
            elif op == "relu":
                y = torch.relu(x)
            elif op == "sigmoid":
                y = torch.sigmoid(x)
            elif op == "softmax":
                y = torch.softmax(x, dim=-1)
            elif op == "mean_pool":
                y = x.mean(dim=1, keepdim=True)
            elif op == "last_frame":
                y = x[:, -1:, :]
            else:
                raise ValueError(f"unknown op {op}")
            bufs[entry["out"]] = y
            if observer is not None:
                observer(entry["out"], y)
        out = bufs[self.meta["output"]]
        return (out[0] if squeeze else out), state

    def _fsmn_block(self, i, attrs, x, state, seen):
        lorder, rorder = attrs["lorder"], attrs["rorder"]
        lstride, rstride = attrs["lstride"], attrs["rstride"]
        cid = attrs["cache"]
        w = self._w[i]
        pad = (lorder - 1) * lstride + rorder * rstride
        ext = torch.cat([state[cid], x], dim=1)
        t_ext = ext.shape[1]
        state[cid] = ext[:, t_ext - pad:] if pad else ext[:, :0]
        t_out = t_ext - pad
        rspan = rorder * rstride
        base = t_ext - (t_out + rspan) + rstride
        # identity path aligned with the (rorder-delayed) output; exact
        # float32 on the int8 path too (its weight 1.0 has no scale)
        start = (lorder - 1) * lstride
        y = ext[:, start:start + t_out]
        if self._q[i] is not None:
            xq = self._quantize(i, ext).to(torch.int32)
            y = y + self._int8_taps(i, "Wl", xq, lorder, lstride, t_out, seen)
            if "Wr" in w and rorder > 0:
                y = y + self._int8_taps(i, "Wr", xq[:, base:], rorder,
                                        rstride, t_out, seen)
            return y
        for tap in range(lorder):
            sl = ext[:, tap * lstride:tap * lstride + t_out]
            y = y + sl * w["Wl"][tap]
        if "Wr" in w and rorder > 0:
            for tap in range(rorder):
                o = base + tap * rstride
                y = y + ext[:, o:o + t_out] * w["Wr"][tap]
        return y

    def _gru(self, i, attrs, x, state):
        cid = attrs["cache"]
        w = self._w[i]
        hid = attrs["hidden"]
        h = state[cid][:, 0, :]
        gi = torch.matmul(x, w["Wih"]) + w["bih"]  # (B, T, 3H)
        outs = []
        for t in range(x.shape[1]):
            gh = torch.matmul(h, w["Whh"]) + w["bhh"]
            xr, xz, xn = gi[:, t].split(hid, dim=-1)
            hr, hz, hn = gh.split(hid, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            outs.append(h)
        state[cid] = h[:, None, :]
        if not outs:
            return gi[..., :hid]
        return torch.stack(outs, dim=1)


class ArtifactModelAdapter:
    """A ``TorchGraphRuntime`` behind the serving engines' model
    contract: ``model(feats, cache, softmax=...) -> (posteriors,
    cache')`` over ``(B, T, D)`` features and ``model.init_cache(B)``,
    the cache a tuple of ``(B, len, dim)`` tensors with the rows on
    axis 0.  There is no fused serving kernel behind a graph artifact:
    the engines step the runtime's ops (``use_fused=True`` raises)."""

    def __init__(self, runtime: TorchGraphRuntime):
        self.rt = runtime
        self.device = runtime.device
        self._has_softmax = any(e["op"] == "softmax" for e in runtime.ops)

    def init_cache(self, batch_size: int, device=None):
        """Zero caches on the runtime's device (``device`` is the
        engine's, the one the runtime was built on)."""
        del device
        return tuple(self.rt.init_state(batch_size))

    def __call__(self, feats, cache=None, softmax: bool = False):
        with torch.inference_mode():
            out, state = self.rt.forward(feats, cache)
            if softmax and not self._has_softmax:
                out = torch.softmax(out, dim=-1)
        return out, tuple(state)


def load_artifact_model(model_dir: str, device="cuda") -> ArtifactModelAdapter:
    """The serving-engine model of an exported artifact directory, on
    ``device``: the artifact twin of ``runtime.keyword_spotter
    .load_serving_model``'s module."""
    return ArtifactModelAdapter(TorchGraphRuntime(model_dir, device))
