"""Weight bridge: a JAX-package checkpoint -> the port's state_dict.

Takes the JAX package's ``(params, batch_stats)`` (nested dicts of
arrays, as its checkpoints hold them), the ``model`` config and the
CMVN statistics, and returns a state_dict with the reference wekws
names the port's modules use.  This is the port's own copy of the
mapping in wekws_tpu/tools/export_torch.py: MDTC, TCN / DS-TCN, FSMN
and GRU backbones, linear and ``cnn1d_s1`` preprocessing, heads and
CMVN.

Layouts (both frameworks use cross-correlation, so only axis
permutations): Dense kernel (in, out) -> Linear (out, in); Conv
kernel (k, in, out) -> Conv1d (out, in, k); depthwise (K, 1, C) ->
(C, 1, K); FSMN memory taps (order, 1, C) -> Conv2d (C, 1, order, 1);
GRU ``ih`` kernel (D, 3H) and ``hh_kernel`` (H, 3H) -> ``weight_ih``
(3H, D) and ``weight_hh`` (3H, H), ``ih`` bias and ``hh_bias`` ->
``bias_ih`` and ``bias_hh`` (gate order r, z, n in both); BN
scale/bias and mean/var -> weight/bias and
running_mean/running_var.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _t(arr) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, np.float32))


def _linear(tree, prefix, out):
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _conv1d(tree, prefix, out):
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(tree["kernel"]),
                                              (2, 1, 0)))
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _bn(params, stats, prefix, out):
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    if stats is None:  # a gradient tree: parameters only
        return
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _mdtc_block(params, stats, prefix, out):
    def sub(*keys):
        tree = stats
        for key in keys:
            tree = None if tree is None else tree[key]
        return tree

    _conv1d(params["conv1"]["dw_conv"], f"{prefix}.conv1.conv", out)
    _bn(params["conv1"]["bn"], sub("conv1", "bn"), f"{prefix}.conv1.bn", out)
    _conv1d(params["conv1"]["pw_conv"], f"{prefix}.conv1.pointwise", out)
    _bn(params["bn1"], sub("bn1"), f"{prefix}.bn1", out)
    _conv1d(params["conv2"], f"{prefix}.conv2", out)
    _bn(params["bn2"], sub("bn2"), f"{prefix}.bn2", out)


def _tcn_block(params, stats, prefix, ds, out):
    """``prefix`` is the block's ``nn.Sequential``: (dw conv, BN, ReLU,
    1x1 conv, BN, ...) or (conv, BN, ...)."""
    def sub(key):
        return None if stats is None else stats[key]

    if ds:
        _conv1d(params["dw_conv"], f"{prefix}.0", out)
        _bn(params["dw_bn"], sub("dw_bn"), f"{prefix}.1", out)
        _conv1d(params["pw_conv"], f"{prefix}.3", out)
        _bn(params["pw_bn"], sub("pw_bn"), f"{prefix}.4", out)
    else:
        _conv1d(params["conv"], f"{prefix}.0", out)
        _bn(params["bn"], sub("bn"), f"{prefix}.1", out)


def _fsmn(bp, num_layers, out):
    for name in ("in_linear1", "in_linear2", "out_linear1", "out_linear2"):
        _linear(bp[name], f"backbone.{name}.linear", out)
    for i in range(num_layers):
        _linear(bp[f"layer_{i}_proj"], f"backbone.fsmn.{i}.0.linear", out)
        taps = bp[f"layer_{i}_fsmn"]
        for side in ("conv_left", "conv_right"):
            if side in taps:
                out[f"backbone.fsmn.{i}.1.{side}.weight"] = _t(np.transpose(
                    np.asarray(taps[side]["kernel"]), (2, 1, 0))[..., None])
        _linear(bp[f"layer_{i}_affine"], f"backbone.fsmn.{i}.2.linear", out)


def state_dict_from_jax(
    params: dict,
    batch_stats: Optional[dict],
    model_conf: dict,
    cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """(params, batch_stats, model config, (mean, istd)) -> port
    state_dict.  Pass ``cmvn`` exactly when the model has GlobalCMVN.
    With ``batch_stats=None`` the BatchNorm buffers are left out, so a
    gradient tree (same structure as ``params``) maps to the port's
    parameter names (see ``grads_from_jax``)."""
    out: Dict[str, torch.Tensor] = {}
    if cmvn is not None:
        out["global_cmvn.mean"] = _t(cmvn[0])
        out["global_cmvn.istd"] = _t(cmvn[1])

    prep = model_conf.get("preprocessing", {}).get("type", "none")
    if prep == "linear":
        _linear(params["preprocessing"]["proj"], "preprocessing.out.0", out)
    elif prep == "cnn1d_s1":
        pp = params["preprocessing"]
        ps = None if batch_stats is None else batch_stats["preprocessing"]
        _conv1d(pp["conv"], "preprocessing.out.0", out)
        _bn(pp["bn"], None if ps is None else ps["bn"],
            "preprocessing.out.1", out)
    elif prep != "none":
        raise ValueError(f"Unknown preprocessing type {prep}")

    bconf = model_conf["backbone"]
    btype = bconf["type"]
    bp = params["backbone"]
    bs = None if batch_stats is None else batch_stats.get("backbone")
    if btype == "mdtc":
        names = [("preprocessor", "backbone.preprocessor")] + [
            (f"stack_{si}_block_{bi}",
             f"backbone.blocks.{si}.res_blocks.{bi}")
            for si in range(bconf["num_stack"])
            for bi in range(bconf["stack_size"])]
        for name, prefix in names:
            _mdtc_block(bp[name], None if bs is None else bs[name], prefix,
                        out)
    elif btype == "tcn":
        for i in range(bconf["num_layers"]):
            name = f"block_{i}"
            _tcn_block(bp[name], None if bs is None else bs[name],
                       f"backbone.network.{i}.cnn", bconf.get("ds", False),
                       out)
    elif btype == "fsmn":
        _fsmn(bp, bconf["num_layers"], out)
    elif btype == "gru":
        for k in range(bconf["num_layers"]):
            layer = bp[f"layer_{k}"]
            out[f"backbone.weight_ih_l{k}"] = _t(
                np.asarray(layer["ih"]["kernel"]).T)
            out[f"backbone.bias_ih_l{k}"] = _t(layer["ih"]["bias"])
            out[f"backbone.weight_hh_l{k}"] = _t(
                np.asarray(layer["hh_kernel"]).T)
            out[f"backbone.bias_hh_l{k}"] = _t(layer["hh_bias"])
    else:
        raise ValueError(f"Unknown backbone type {btype}")

    cls = params.get("classifier", {})
    if "linear" in cls:
        _linear(cls["linear"], "classifier.linear", out)
    elif "mlp" in cls:
        _linear(cls["mlp"]["fc1"], "classifier.classifier.0", out)
        _linear(cls["mlp"]["fc2"], "classifier.classifier.3", out)
    return out


def grads_from_jax(grads: dict, model_conf: dict) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree (the structure of ``params``) -> {port
    parameter name: gradient}, comparable with ``p.grad`` of
    ``named_parameters()``."""
    return state_dict_from_jax(grads, None, model_conf)


def model_from_jax(params: dict, batch_stats: Optional[dict],
                   model_conf: dict):
    """Port KWSModel (CPU, eval) holding the JAX model's weights; the
    CMVN statistics come from ``model_conf`` as in the JAX package."""
    from wekws_tpu_torch.models.kws_model import init_model

    model = init_model(model_conf)
    cmvn = None
    if model.global_cmvn is not None:
        cmvn = (model.global_cmvn.mean.numpy(), model.global_cmvn.istd.numpy())
    model.load_state_dict(
        state_dict_from_jax(params, batch_stats, model_conf, cmvn))
    return model
