"""KWS model composition and config-driven factory.

Port of wekws_tpu/models/kws_model.py: optional GlobalCMVN ->
preprocessing -> backbone (+cache) -> classifier -> activation
(sigmoid for wake word, identity otherwise), with a softmax variant.
Features past ``lengths`` are zero-masked before and after CMVN.

The port builds the MDTC, TCN / DS-TCN, FSMN and GRU backbones with
``linear``, ``cnn1d_s1`` or ``none`` preprocessing and the linear,
element, global, last and identity heads, with MDTC's
``backbone.fused_train`` routing whole-utterance training forwards
through the fused exact-BN kernels.  The JAX package's training knobs:
``dtype`` (e.g. ``bfloat16``) is the backbone's compute dtype for its
convolutions and dense layers, with float32 parameters, BN statistics,
loss and outputs (``models/layers.py``); ``backbone.bn_dtype`` narrows
the BatchNorms' output; ``backbone.ghost_bn: G`` gives them per-group
statistics; ``backbone.remat`` (MDTC only, as in JAX) recomputes each
block in the backward.  The preprocessing and the heads stay float32.
A GRU config that names another ``dtype`` trains in float32 with the
JAX package's warning.  The inference loaders build a config's model
through ``inference_model_conf``, which drops ``dtype`` and the
backbone's ``bn_dtype``: in the JAX package they are the backbone's
compute dtypes only (parameters and checkpoints are float32), and its
fused serving has no dtype at all.
"""

import logging
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from wekws_tpu_torch.frontend.cmvn import load_cmvn
from wekws_tpu_torch.models.classifier import (
    ElementClassifier,
    GlobalClassifier,
    IdentityClassifier,
    LastClassifier,
    LinearClassifier,
)
from wekws_tpu_torch.models.cmvn import GlobalCMVN
from wekws_tpu_torch.models.fsmn import FSMN
from wekws_tpu_torch.models.gru import GRU
from wekws_tpu_torch.models.layers import (
    Conv1d,
    DepthwiseConv1d,
    MemoryTaps,
    PointwiseConv1d,
)
from wekws_tpu_torch.models.mdtc import MDTC
from wekws_tpu_torch.models.subsampling import (
    Conv1dSubsampling1,
    LinearSubsampling1,
    NoSubsampling,
)
from wekws_tpu_torch.models.tcn import TCN


def mask_padding(x: torch.Tensor,
                 lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero features past each utterance's length (pad frames)."""
    if lengths is None:
        return x
    t = x.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    return torch.where(mask[:, :, None], x, torch.zeros((), device=x.device))


class KWSModel(nn.Module):
    def __init__(self, idim: int, odim: int, hdim: int,
                 global_cmvn: Optional[GlobalCMVN], preprocessing: nn.Module,
                 backbone: nn.Module, classifier: nn.Module,
                 activation: str = "sigmoid"):
        super().__init__()
        self.idim = idim
        self.odim = odim
        self.hdim = hdim
        self.global_cmvn = global_cmvn
        self.preprocessing = preprocessing
        self.backbone = backbone
        self.classifier = classifier
        self.activation = activation

    def init_cache(self, batch_size: int, device="cpu"):
        return self.backbone.init_cache(batch_size, device)

    def forward(self, x: torch.Tensor, cache=None,
                lengths: Optional[torch.Tensor] = None,
                softmax: bool = False):
        x = mask_padding(x, lengths)
        if self.global_cmvn is not None:
            x = mask_padding(self.global_cmvn(x), lengths)
        x = self.preprocessing(x)
        x, out_cache = self.backbone(x, cache)
        x = self.classifier(x, lengths)
        if self.activation == "sigmoid":
            x = torch.sigmoid(x)
        if softmax:
            x = torch.softmax(x, dim=-1)
        return x, out_cache


def inference_model_conf(configs: dict) -> dict:
    """A copy of the ``model`` config for scoring, serving and export,
    without ``dtype`` and the backbone's ``bn_dtype`` (the JAX export
    CLI drops both: ``bn_dtype`` rides with the training dtype): the
    model runs float32, as the JAX package's fused serving does, so its
    module route and the fused kernels compute the same function.  Logs
    each drop where the config named another dtype."""
    conf = dict(configs)
    dtype = conf.pop("dtype", None)
    if dtype and dtype != "float32":
        logging.warning("model.dtype %r dropped for inference: the model "
                        "runs float32 (its parameters are float32)", dtype)
    if isinstance(conf.get("backbone"), dict) and "bn_dtype" in conf[
            "backbone"]:
        conf["backbone"] = dict(conf["backbone"])
        bn_dtype = conf["backbone"].pop("bn_dtype")
        if bn_dtype and bn_dtype != "float32":
            logging.warning("model.backbone.bn_dtype %r dropped for "
                            "inference: the BatchNorms run float32",
                            bn_dtype)
    return conf


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's dtype name (``bfloat16``, ``float32``, ...) as a torch
    dtype; None for none."""
    if not name:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown floating dtype {name!r}")
    return dtype


# standard deviation of N(0, 1) truncated to [-2, 2]: flax's
# variance_scaling divides by it so that the draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def truncated_lecun_normal(shape, fan_in: int,
                           generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal()``: N(0, 1) truncated to [-2, 2] (by the
    inverse CDF of a uniform draw, as ``jax.random.truncated_normal``),
    times sqrt(1/fan_in) / 0.87962566; the same distribution as the
    JAX package's initialiser, not the same numbers."""
    lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    z = torch.clamp(z, -2.0, 2.0)
    return (z / (_TRUNC_STD * math.sqrt(fan_in))).to(torch.float32)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation as flax draws it: weights from the
    truncated lecun normal (``truncated_lecun_normal``), biases zero,
    BatchNorm at identity.  A GRU layer's input and hidden products
    draw with fan_in D and H (flax's ``ih`` Dense and ``hh_kernel``)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, GRU):
                for name, prm in mod.named_parameters():
                    if name.startswith("weight"):
                        prm.copy_(truncated_lecun_normal(
                            prm.shape, prm.shape[1], generator))
                    else:
                        prm.zero_()
                continue
            if isinstance(mod, (nn.Linear, PointwiseConv1d)):
                fan_in = mod.weight.shape[1]
            elif isinstance(mod, DepthwiseConv1d):
                fan_in = mod.kernel_size
            elif isinstance(mod, Conv1d):
                fan_in = mod.weight.shape[1] * mod.kernel_size
            elif isinstance(mod, MemoryTaps):
                fan_in = mod.order
            else:
                continue
            mod.weight.copy_(truncated_lecun_normal(mod.weight.shape,
                                                    fan_in, generator))
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()


def init_model(configs: dict,
               generator: Optional[torch.Generator] = None) -> KWSModel:
    """Build a KWSModel from a wekws-style resolved ``model`` config,
    on the CPU and in eval mode, with weights drawn from ``generator``
    (seed 0 when omitted).  Move it with ``.to(device)``; the Trainer
    moves it and switches modes itself."""
    cmvn_conf = configs.get("cmvn", {}) or {}
    global_cmvn = None
    if cmvn_conf.get("cmvn_file") is not None:
        mean, istd = load_cmvn(cmvn_conf["cmvn_file"])
    elif cmvn_conf.get("mean") is not None:
        mean = np.asarray(cmvn_conf["mean"], np.float32)
        istd = np.asarray(cmvn_conf["istd"], np.float32)
    else:
        mean = istd = None
    input_dim = configs["input_dim"]
    if mean is not None:
        if len(mean) != input_dim and input_dim % len(mean) == 0:
            # context-expanded input: tile per-frame stats across the
            # splice window
            reps = input_dim // len(mean)
            mean, istd = np.tile(mean, reps), np.tile(istd, reps)
        global_cmvn = GlobalCMVN(mean, istd, cmvn_conf.get("norm_var", True))

    output_dim = configs["output_dim"]
    hidden_dim = configs["hidden_dim"]
    prep_type = configs["preprocessing"]["type"]
    if prep_type == "linear":
        preprocessing = LinearSubsampling1(input_dim, hidden_dim)
    elif prep_type == "none":
        preprocessing = NoSubsampling()
    elif prep_type == "cnn1d_s1":
        preprocessing = Conv1dSubsampling1(input_dim, hidden_dim)
    else:
        raise ValueError(f"Unknown preprocessing type {prep_type}")

    bconf = configs["backbone"]
    btype = bconf["type"]
    # the compute dtype: float32 casts nothing (the parameters are)
    dtype = configs.get("dtype")
    compute_dtype = None if dtype in (None, "float32") else _dtype(dtype)
    knobs = dict(dtype=compute_dtype,
                 ghost_bn=int(bconf.get("ghost_bn", 0) or 0),
                 bn_dtype=_dtype(bconf.get("bn_dtype")))
    if btype == "gru" and compute_dtype is not None:
        logging.warning(
            "model.dtype=%s is not supported for the gru backbone "
            "(sequential cell, f32 recurrence kept); training in "
            "float32", dtype)
    if btype == "mdtc":
        hidden_dim = bconf["hidden_dim"]
        backbone = MDTC(
            stack_num=bconf["num_stack"],
            stack_size=bconf["stack_size"],
            in_channels=hidden_dim,
            res_channels=hidden_dim,
            kernel_size=bconf["kernel_size"],
            causal=bconf["causal"],
            fused_train=bool(bconf.get("fused_train", False)),
            remat=bool(bconf.get("remat", False)),
            **knobs,
        )
    elif btype == "tcn":
        backbone = TCN(
            num_layers=bconf["num_layers"],
            channel=hidden_dim,
            kernel_size=bconf.get("kernel_size", 8),
            dropout=bconf.get("dropout", 0.1),
            ds=bconf.get("ds", False),
            **knobs,
        )
    elif btype == "fsmn":
        backbone = FSMN(
            input_dim=hidden_dim if prep_type == "linear" else input_dim,
            input_affine_dim=bconf["input_affine_dim"],
            fsmn_layers=bconf["num_layers"],
            linear_dim=bconf["linear_dim"],
            proj_dim=bconf["proj_dim"],
            lorder=bconf["left_order"],
            rorder=bconf["right_order"],
            lstride=bconf["left_stride"],
            rstride=bconf["right_stride"],
            output_affine_dim=bconf["output_affine_dim"],
            output_dim=output_dim,
            dtype=compute_dtype,
        )
    elif btype == "gru":
        backbone = GRU(input_dim if prep_type == "none" else hidden_dim,
                       hidden_dim, bconf["num_layers"])
    else:
        raise ValueError(f"Unknown backbone type {btype}")

    if "classifier" in configs:
        ctype = configs["classifier"]["type"]
        dropout = configs["classifier"].get("dropout", 0.1)
        heads = {"element": ElementClassifier, "global": GlobalClassifier,
                 "last": LastClassifier}
        if ctype in heads:
            classifier = heads[ctype](hidden_dim, output_dim, dropout)
        elif ctype == "identity":
            classifier = IdentityClassifier()
        else:
            raise ValueError(f"Unknown classifier type {ctype}")
        activation = "identity"
    else:
        classifier = LinearClassifier(hidden_dim, output_dim)
        activation = "sigmoid"
    if "activation" in configs:
        atype = configs["activation"]["type"]
        if atype != "identity":
            raise ValueError(f"Unknown activation type {atype}")
        activation = "identity"

    model = KWSModel(input_dim, output_dim, hidden_dim, global_cmvn,
                     preprocessing, backbone, classifier, activation)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.eval()
