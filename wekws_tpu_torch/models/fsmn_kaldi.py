"""Kaldi nnet1-text import/export of FSMN weights.

Port of wekws_tpu/models/fsmn_kaldi.py over the port's ``FSMN`` module
and its state_dict (numpy inside; the text is the JAX package's, byte
for byte, for the same weights).  The network serializes as <Nnet>
AffineTransform x2, RectifiedLinear, then per layer LinearTransform +
<Fsmn> (left taps flipped oldest-first, right taps in order) +
AffineTransform + RectifiedLinear, the two output affines and a
<Softmax> tag.  Kaldi stores affine weights (out, in), as
``nn.Linear`` does; the memory taps ``(C, 1, order, 1)`` are written as
(order, C) rows.  The round trip is the identity.
"""

from typing import Dict

import numpy as np
import torch


def _matrix(rows: np.ndarray) -> str:
    lines = []
    for i, row in enumerate(np.atleast_2d(rows)):
        prefix = "[ " if i == 0 else "  "
        lines.append(prefix + " ".join(f"{v:.7g}" for v in row))
    lines[-1] += " ]"
    return "\n".join(lines)


def _np(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).detach().cpu(), np.float32)


def _affine(name: str, weight: np.ndarray, bias: np.ndarray = None) -> str:
    out_dim, in_dim = weight.shape
    parts = [f"<{name}> {out_dim} {in_dim}"]
    if name == "AffineTransform":
        parts.append("<LearnRateCoef> 1 <BiasLearnRateCoef> 1 <MaxNorm> 0")
    else:
        parts.append("<LearnRateCoef> 1")
    parts.append(_matrix(weight))
    if bias is not None:
        parts.append(_matrix(bias[None, :]))
    return "\n".join(parts)


def _taps(weight: np.ndarray) -> np.ndarray:
    """Conv2d weight (C, 1, order, 1) -> (order, C)."""
    return weight[:, 0, :, 0].T


def fsmn_to_kaldi(module, state_dict: Dict) -> str:
    """The port's FSMN ``module`` (its shape) and its ``state_dict``
    (names relative to the module) -> Kaldi nnet text."""
    sd = {k: _np(v) for k, v in state_dict.items()}

    def affine(prefix, name="AffineTransform"):
        return _affine(name, sd[f"{prefix}.linear.weight"],
                       sd.get(f"{prefix}.linear.bias"))

    out = ["<Nnet>", affine("in_linear1"), affine("in_linear2"),
           f"<RectifiedLinear> {module.linear_dim} {module.linear_dim}"]
    for i in range(module.fsmn_layers):
        out.append(affine(f"fsmn.{i}.0", "LinearTransform"))
        d = module.proj_dim
        out.append(f"<Fsmn> {d} {d}")
        out.append(
            f"<LearnRateCoef> 1 <LOrder> {module.lorder} "
            f"<ROrder> {module.rorder} <LStride> {module.lstride} "
            f"<RStride> {module.rstride} <MaxNorm> 0"
        )
        left = _taps(sd[f"fsmn.{i}.1.conv_left.weight"])
        out.append(_matrix(left[::-1]))  # oldest tap first
        if module.rorder > 0:
            out.append(_matrix(_taps(sd[f"fsmn.{i}.1.conv_right.weight"])))
        out.append(affine(f"fsmn.{i}.2"))
        out.append(
            f"<RectifiedLinear> {module.linear_dim} {module.linear_dim}"
        )
    out.append(affine("out_linear1"))
    out.append(affine("out_linear2"))
    output_dim = module.out_linear2.linear.out_features
    out.append(f"<Softmax> {output_dim} {output_dim}")
    out.append("</Nnet>")
    return "\n".join(out) + "\n"


class _Reader:
    def __init__(self, text: str):
        self.tokens = text.replace("[", " [ ").replace("]", " ] ").split()
        self.pos = 0

    def next(self) -> str:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, tok: str):
        got = self.next()
        if got != tok:
            raise ValueError(f"expected {tok}, got {got}")

    def skip_until(self, tok: str):
        while self.next() != tok:
            pass

    def matrix(self, rows: int, cols: int) -> np.ndarray:
        self.expect("[")
        vals = []
        while True:
            tok = self.next()
            if tok == "]":
                break
            vals.append(float(tok))
        arr = np.asarray(vals, np.float32)
        if arr.size != rows * cols:
            raise ValueError(f"matrix of {arr.size} values, want {rows} x "
                             f"{cols}")
        return arr.reshape(rows, cols)


def fsmn_from_kaldi(module, text: str) -> Dict[str, torch.Tensor]:
    """Kaldi nnet text -> a state_dict for the port's FSMN ``module``
    (``module.load_state_dict`` takes it)."""
    r = _Reader(text)
    r.expect("<Nnet>")
    sd: Dict[str, np.ndarray] = {}

    def affine(prefix):
        r.expect("<AffineTransform>")
        out_dim, in_dim = int(r.next()), int(r.next())
        r.skip_until("<MaxNorm>")
        r.next()  # maxnorm value
        sd[f"{prefix}.linear.weight"] = r.matrix(out_dim, in_dim)
        sd[f"{prefix}.linear.bias"] = r.matrix(1, out_dim)[0]

    affine("in_linear1")
    affine("in_linear2")
    r.expect("<RectifiedLinear>")
    r.next(), r.next()
    for i in range(module.fsmn_layers):
        r.expect("<LinearTransform>")
        out_dim, in_dim = int(r.next()), int(r.next())
        r.expect("<LearnRateCoef>")
        r.next()
        sd[f"fsmn.{i}.0.linear.weight"] = r.matrix(out_dim, in_dim)
        r.expect("<Fsmn>")
        d = int(r.next())
        r.next()
        r.skip_until("<MaxNorm>")
        r.next()
        left = r.matrix(module.lorder, d)[::-1]  # back to newest-last
        sd[f"fsmn.{i}.1.conv_left.weight"] = left.T[:, None, :, None]
        if module.rorder > 0:
            right = r.matrix(module.rorder, d)
            sd[f"fsmn.{i}.1.conv_right.weight"] = right.T[:, None, :, None]
        affine(f"fsmn.{i}.2")
        r.expect("<RectifiedLinear>")
        r.next(), r.next()
    affine("out_linear1")
    affine("out_linear2")
    r.expect("<Softmax>")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}
