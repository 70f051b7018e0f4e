"""Model export: lower a port KWSModel to a portable graph artifact.

Port of wekws_tpu/export/graph.py.  The artifact format is the JAX
package's, byte for byte (the C++ streaming runtime under runtime/
reads only this format):

  <out_dir>/model.json   op graph (SSA over (T, C) buffers), cache
                         spec, feature config, and weight index
  <out_dir>/model.txt    the same as line records, for the C++ runtime
  <out_dir>/weights.bin  raw little-endian float32

The model is lowered from the module's own attributes and state_dict
(the reference wekws names; layouts permuted to the JAX package's, a
Linear ``(out, in)`` to a dense ``(in, out)``, a Conv1d ``(out, in, k)``
to ``(k, in, out)``).  BatchNorm layers are folded into their preceding
convolutions in float64 (``ops.fused_common.fold_bn``, as the JAX
package folds), so the two packages write the same ``weights.bin``.
Every causal op owns a left-context cache slot whose length equals its
receptive-field padding; ``meta`` records the total cache_len and
cache_dim and keeps the training config's ``model`` section untouched.

Ops:
  dense        W (Cin,Cout), b?            attrs: act in {none,relu,sigmoid}
  conv         W (k,Cin,Cout), b?          attrs: dilation, cache, act
  dw_conv      W (k,C), b?                 attrs: dilation, cache, act
  fsmn_block   Wl (lorder,C), Wr (rorder,C) attrs: lstride, rstride, cache
  gru          Wih (Cin,3H), bih, Whh (H,3H), bhh   attrs: cache (hidden)
  add          inputs [a, b]
  relu / sigmoid / softmax
  cmvn         mean (C), istd (C)
  mean_pool / last_frame    (offline classifier heads)
"""

import json
import os
from typing import Dict, List, Optional

import numpy as np

BN_EPS = 1e-5


def is_artifact_dir(path: str) -> bool:
    """True for an exported artifact directory (one with a model.json)."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "model.json"))


class _Builder:
    def __init__(self):
        self.ops: List[Dict] = []
        self.weights: List[np.ndarray] = []
        self.caches: List[Dict] = []
        self.next_buf = 1  # 0 is the input

    def weight(self, arr) -> Dict:
        arr = np.ascontiguousarray(_np(arr))
        offset = sum(w.size for w in self.weights)
        self.weights.append(arr)
        return {"offset": int(offset), "shape": list(arr.shape)}

    def cache(self, length: int, dim: int) -> int:
        cid = len(self.caches)
        self.caches.append({"id": cid, "len": int(length), "dim": int(dim)})
        return cid

    def op(self, op: str, inputs: List[int], attrs: Optional[Dict] = None,
           **weight_arrays) -> int:
        out = self.next_buf
        self.next_buf += 1
        entry = {"op": op, "inputs": inputs, "out": out}
        if attrs:
            entry["attrs"] = attrs
        for name, arr in weight_arrays.items():
            if arr is not None:
                entry[name] = self.weight(arr)
        self.ops.append(entry)
        return out


def _np(t) -> np.ndarray:
    """A tensor (or array) as a float32 numpy array on the host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _dense_w(linear_weight) -> np.ndarray:
    """Linear / pointwise weight ``(out, in[, 1])`` -> dense ``(in, out)``."""
    w = _np(linear_weight)
    return w.reshape(w.shape[0], w.shape[1]).T


def _fold_bn(w, b, bn):
    """Fold an eval-mode BatchNorm module into ``(w, b)`` (w's last axis
    the output channels) in float64; float32 numpy out."""
    from wekws_tpu_torch.ops.fused_common import fold_bn

    fw, fb = fold_bn(w, b, bn.weight, bn.bias, bn.running_mean,
                     bn.running_var, eps=BN_EPS)
    return fw.numpy(), fb.numpy()


def _lower_tcn(b: _Builder, x: int, module) -> int:
    k = module.kernel_size
    for i, block in enumerate(module.network):
        dilation = 2 ** i
        pad = (k - 1) * dilation
        if module.ds:
            dw, dw_bn, _, pw, pw_bn = list(block.cnn)[:5]
            dw_w, dw_b = _fold_bn(_np(dw.weight)[:, 0, :].T, dw.bias, dw_bn)
            pw_w, pw_b = _fold_bn(_dense_w(pw.weight), pw.bias, pw_bn)
            cid = b.cache(pad, dw_w.shape[1])
            y = b.op("dw_conv", [x],
                     {"dilation": dilation, "cache": cid, "act": "relu"},
                     W=dw_w, b_=dw_b)
            y = b.op("dense", [y], {"act": "relu"}, W=pw_w, b_=pw_b)
        else:
            conv, bn = block.cnn[0], block.cnn[1]
            w, bias = _fold_bn(np.transpose(_np(conv.weight), (2, 1, 0)),
                               conv.bias, bn)
            cid = b.cache(pad, w.shape[1])
            y = b.op("conv", [x],
                     {"dilation": dilation, "cache": cid, "act": "relu"},
                     W=w, b_=bias)
        x = b.op("add", [y, x])
    return x


def _lower_mdtc_block(b: _Builder, x: int, block, residual: bool) -> int:
    pad = (block.kernel_size - 1) * block.dilation
    conv1 = block.conv1
    # conv1: dw conv -> bn (folded into dw) -> pointwise
    dw_w, dw_b = _fold_bn(_np(conv1.conv.weight)[:, 0, :].T, conv1.conv.bias,
                          conv1.bn)
    cid = b.cache(pad, dw_w.shape[1])
    y = b.op("dw_conv", [x],
             {"dilation": block.dilation, "cache": cid, "act": "none"},
             W=dw_w, b_=dw_b)
    # pointwise conv1 then bn1 (fold bn1 into pointwise) then relu
    pw_w, pw_b = _fold_bn(_dense_w(conv1.pointwise.weight),
                          conv1.pointwise.bias, block.bn1)
    y = b.op("dense", [y], {"act": "relu"}, W=pw_w, b_=pw_b)
    # conv2 1x1 + bn2 folded
    c2_w, c2_b = _fold_bn(_dense_w(block.conv2.weight), block.conv2.bias,
                          block.bn2)
    y = b.op("dense", [y], {"act": "none"}, W=c2_w, b_=c2_b)
    if residual:
        y = b.op("add", [y, x])
    return b.op("relu", [y])


def _lower_mdtc(b: _Builder, x: int, module) -> int:
    x = _lower_mdtc_block(b, x, module.preprocessor,
                          module.in_channels == module.res_channels)
    x = b.op("relu", [x])
    acc = None
    for stack in module.blocks:
        for block in stack.res_blocks:
            x = _lower_mdtc_block(b, x, block, True)
        acc = x if acc is None else b.op("add", [acc, x])
    return acc


def _lower_fsmn(b: _Builder, x: int, module) -> int:
    def dense(x, affine, act):
        lin = affine.linear
        return b.op("dense", [x], {"act": act}, W=_dense_w(lin.weight),
                    b_=None if lin.bias is None else lin.bias)

    x = dense(x, module.in_linear1, "none")
    x = dense(x, module.in_linear2, "relu")
    for proj, block, affine, _ in module.fsmn:
        x = dense(x, proj, "none")
        cid = b.cache(module.layer_padding, module.proj_dim)
        wl = _np(block.conv_left.weight)[:, 0, :, 0].T  # (lorder, C)
        wr = (_np(block.conv_right.weight)[:, 0, :, 0].T
              if module.rorder > 0 else None)
        x = b.op("fsmn_block", [x],
                 {"lorder": module.lorder, "rorder": module.rorder,
                  "lstride": module.lstride, "rstride": module.rstride,
                  "cache": cid},
                 Wl=wl, Wr=wr)
        x = dense(x, affine, "relu")
    x = dense(x, module.out_linear1, "none")
    return dense(x, module.out_linear2, "none")


def _lower_gru(b: _Builder, x: int, module) -> int:
    for k in range(module.num_layers):
        w_ih, b_ih, w_hh, b_hh = module.layer_weights(k)
        cid = b.cache(1, module.hidden_dim)  # hidden state slot
        x = b.op("gru", [x], {"cache": cid, "hidden": module.hidden_dim},
                 Wih=_np(w_ih).T, bih=b_ih, Whh=_np(w_hh).T, bhh=b_hh)
    return x


def export_model(model, configs: dict, out_dir: str) -> dict:
    """Lower ``model`` (a port KWSModel, eval-mode state) to an artifact
    in ``out_dir``; returns the artifact dict (model.json's content).

    configs: the resolved training config (model + dataset_conf) — its
    dataset_conf is embedded so the runtime frontend matches training,
    its ``model`` section is kept as it is."""
    from wekws_tpu_torch.models.classifier import (
        ElementClassifier,
        GlobalClassifier,
        IdentityClassifier,
        LastClassifier,
        LinearClassifier,
    )
    from wekws_tpu_torch.models.fsmn import FSMN
    from wekws_tpu_torch.models.gru import GRU
    from wekws_tpu_torch.models.mdtc import MDTC
    from wekws_tpu_torch.models.subsampling import (
        Conv1dSubsampling1,
        LinearSubsampling1,
        NoSubsampling,
    )
    from wekws_tpu_torch.models.tcn import TCN

    b = _Builder()
    x = 0

    if model.global_cmvn is not None:
        mean = _np(model.global_cmvn.mean)
        istd = _np(model.global_cmvn.istd)
        if not model.global_cmvn.norm_var:
            istd = np.ones_like(istd)
        x = b.op("cmvn", [x], {}, mean=mean, istd=istd)

    prep = model.preprocessing
    if isinstance(prep, LinearSubsampling1):
        lin = prep.out[0]
        x = b.op("dense", [x], {"act": "relu"}, W=_dense_w(lin.weight),
                 b_=lin.bias)
    elif isinstance(prep, Conv1dSubsampling1):
        conv, bn = prep.out[0], prep.out[1]
        w, bias = _fold_bn(np.transpose(_np(conv.weight), (2, 1, 0)),
                           conv.bias, bn)
        cid = b.cache(2, w.shape[1])
        x = b.op("conv", [x], {"dilation": 1, "cache": cid, "act": "relu"},
                 W=w, b_=bias)
    elif not isinstance(prep, NoSubsampling):
        raise ValueError(f"cannot export preprocessing {type(prep)}")

    backbone = model.backbone
    if isinstance(backbone, TCN):
        x = _lower_tcn(b, x, backbone)
    elif isinstance(backbone, MDTC):
        x = _lower_mdtc(b, x, backbone)
    elif isinstance(backbone, FSMN):
        x = _lower_fsmn(b, x, backbone)
    elif isinstance(backbone, GRU):
        x = _lower_gru(b, x, backbone)
    else:
        raise ValueError(f"cannot export backbone {type(backbone)}")

    clf = model.classifier

    def lower_mlp(x, mlp):
        fc1, fc2 = mlp[0], mlp[3]
        x = b.op("dense", [x], {"act": "relu"}, W=_dense_w(fc1.weight),
                 b_=fc1.bias)
        return b.op("dense", [x], {"act": "none"}, W=_dense_w(fc2.weight),
                    b_=fc2.bias)

    if isinstance(clf, LinearClassifier):
        x = b.op("dense", [x], {"act": "none"}, W=_dense_w(clf.linear.weight),
                 b_=clf.linear.bias)
    elif isinstance(clf, GlobalClassifier):
        x = b.op("mean_pool", [x])
        x = lower_mlp(x, clf.classifier)
    elif isinstance(clf, LastClassifier):
        x = b.op("last_frame", [x])
        x = lower_mlp(x, clf.classifier)
    elif isinstance(clf, ElementClassifier):
        x = lower_mlp(x, clf.classifier)
    elif not isinstance(clf, IdentityClassifier):
        raise ValueError(f"cannot export classifier {type(clf)}")

    if model.activation == "sigmoid":
        x = b.op("sigmoid", [x])

    cache_len = sum(c["len"] for c in b.caches)
    cache_dim = max((c["dim"] for c in b.caches), default=0)
    meta = {
        "format_version": 1,
        "output": x,
        "output_dim": int(model.odim),
        "cache_len": int(cache_len),
        "cache_dim": int(cache_dim),
        "activation": model.activation,
        "dataset_conf": configs.get("dataset_conf", {}),
        "model_conf": configs.get("model", {}),
    }
    artifact = {"meta": meta, "ops": b.ops, "caches": b.caches}

    os.makedirs(out_dir, exist_ok=True)
    flat = (
        np.concatenate([w.reshape(-1) for w in b.weights])
        if b.weights else np.zeros((0,), np.float32)
    )
    flat.astype("<f4").tofile(os.path.join(out_dir, "weights.bin"))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(artifact, f)
    write_text_format(artifact, os.path.join(out_dir, "model.txt"))
    return artifact


def write_text_format(artifact: dict, path: str) -> None:
    """Line-based artifact description for the C++ runtime (no JSON
    dependency).  Grammar (space-separated, one record per line):

      version 1
      meta <output_buf> <output_dim> <cache_len> <cache_dim> <activation>
      feature <key> <value>            (repeated; frontend parameters)
      cache <id> <len> <dim>           (repeated)
      op <name> <out_buf> <n_in> <in..> [a <key> <val>]* [w <name> <off>
          <ndim> <dims..>]* [q <name> <int8 off> <scale off> <ndim>
          <dims..>]*
    """
    meta = artifact["meta"]
    lines = ["version 1"]
    lines.append(
        "meta {} {} {} {} {}".format(
            meta["output"], meta["output_dim"], meta["cache_len"],
            meta["cache_dim"], meta["activation"],
        )
    )
    dconf = meta.get("dataset_conf", {})
    if dconf:
        from wekws_tpu_torch.frontend.features import (
            frontend_from_dataset_conf,
        )

        cfg = frontend_from_dataset_conf(dconf).cfg
        lines.append(f"feature feature_type {cfg.feature_type}")
        lines.append(f"feature sample_rate {cfg.sample_rate}")
        lines.append(f"feature num_mel_bins {cfg.num_mel_bins}")
        lines.append(f"feature num_ceps {cfg.num_ceps}")
        lines.append(f"feature frame_length_ms {cfg.frame_length_ms:g}")
        lines.append(f"feature frame_shift_ms {cfg.frame_shift_ms:g}")
        ce = dconf.get("context_expansion_conf", {}) \
            if dconf.get("context_expansion") else {}
        lines.append(f"feature context_left {ce.get('left', 0)}")
        lines.append(f"feature context_right {ce.get('right', 0)}")
        lines.append(f"feature frame_skip {dconf.get('frame_skip', 1)}")
    for c in artifact["caches"]:
        lines.append(f"cache {c['id']} {c['len']} {c['dim']}")
    for entry in artifact["ops"]:
        parts = ["op", entry["op"], str(entry["out"]),
                 str(len(entry["inputs"]))]
        parts += [str(i) for i in entry["inputs"]]
        for key, val in entry.get("attrs", {}).items():
            parts += ["a", key, str(val)]
        for key, val in entry.items():
            if isinstance(val, dict) and "offset" in val:
                parts += ["w", key, str(val["offset"]),
                          str(len(val["shape"]))]
                parts += [str(d) for d in val["shape"]]
            elif isinstance(val, dict) and "int8" in val:
                qr, sr = val["int8"], val["scale"]
                parts += ["q", key, str(qr["offset"]), str(sr["offset"]),
                          str(len(qr["shape"]))]
                parts += [str(d) for d in qr["shape"]]
        lines.append(" ".join(parts))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_artifact(model_dir: str):
    """-> (artifact dict, float32 weights) of a float artifact."""
    with open(os.path.join(model_dir, "model.json")) as f:
        artifact = json.load(f)
    weights = np.fromfile(
        os.path.join(model_dir, "weights.bin"), dtype="<f4"
    )
    return artifact, weights


def load_any(model_dir: str):
    """-> (artifact, float32 weights, int8 weights or None) of a float or
    quantized artifact (``weights_int8.bin`` present)."""
    from wekws_tpu_torch.export.quantize import load_quantized

    if os.path.exists(os.path.join(model_dir, "weights_int8.bin")):
        return load_quantized(model_dir)
    return (*load_artifact(model_dir), None)
