"""Weight bridge: a JAX-package checkpoint -> the port's state_dict.

Takes the JAX package's ``(params, batch_stats)`` (nested dicts of
arrays, as its checkpoints hold them), the ``model`` config and the
CMVN statistics, and returns a state_dict with the reference wekws
names the port's modules use.  This is the port's own copy of the
MDTC, linear-preprocessing, head and CMVN parts of the mapping in
wekws_tpu/tools/export_torch.py; other backbones come with their
modules.

Layouts (both frameworks use cross-correlation, so only axis
permutations): Dense kernel (in, out) -> Linear (out, in); Conv
kernel (k, in, out) -> Conv1d (out, in, k); depthwise (K, 1, C) ->
(C, 1, K); BN scale/bias and mean/var -> weight/bias and
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
    elif prep != "none":
        raise NotImplementedError(f"preprocessing {prep!r} is not bridged")

    bconf = model_conf["backbone"]
    if bconf["type"] != "mdtc":
        raise NotImplementedError(
            f"backbone {bconf['type']!r} is not ported yet (ROADMAP queue A, "
            "item 7, other backbones)"
        )
    bp = params["backbone"]
    bs = None if batch_stats is None else batch_stats["backbone"]
    names = [("preprocessor", "backbone.preprocessor")] + [
        (f"stack_{si}_block_{bi}", f"backbone.blocks.{si}.res_blocks.{bi}")
        for si in range(bconf["num_stack"])
        for bi in range(bconf["stack_size"])]
    for name, prefix in names:
        _mdtc_block(bp[name], None if bs is None else bs[name], prefix, out)

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
