"""KWS model composition and config-driven factory.

Port of wekws_tpu/models/kws_model.py: optional GlobalCMVN ->
preprocessing -> backbone (+cache) -> classifier -> activation
(sigmoid for wake word, identity otherwise), with a softmax variant.
Features past ``lengths`` are zero-masked before and after CMVN.

The port builds the MDTC backbone with ``linear`` or ``none``
preprocessing and the linear, element and identity heads, in float32,
with ``backbone.fused_train`` routing whole-utterance training forwards
through the fused exact-BN kernels; other configurations and the
training knobs ``dtype: bfloat16``, ``bn_dtype``, ``remat`` and
``ghost_bn > 1`` raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from wekws_tpu_torch.frontend.cmvn import load_cmvn
from wekws_tpu_torch.models.classifier import (
    ElementClassifier,
    IdentityClassifier,
    LinearClassifier,
)
from wekws_tpu_torch.models.cmvn import GlobalCMVN
from wekws_tpu_torch.models.layers import DepthwiseConv1d, PointwiseConv1d
from wekws_tpu_torch.models.mdtc import MDTC
from wekws_tpu_torch.models.subsampling import LinearSubsampling1, NoSubsampling


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
        x = self.classifier(x)
        if self.activation == "sigmoid":
            x = torch.sigmoid(x)
        if softmax:
            x = torch.softmax(x, dim=-1)
        return x, out_cache


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to wekws_tpu_torch yet (ROADMAP queue A, "
        f"{item})"
    )


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: weights ~ N(0, 1/fan_in) (flax's
    lecun-normal scale without truncation), biases zero, BatchNorm at
    identity."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, PointwiseConv1d)):
                fan_in = mod.weight.shape[1]
            elif isinstance(mod, DepthwiseConv1d):
                fan_in = mod.kernel_size
            else:
                continue
            mod.weight.copy_(
                torch.randn(mod.weight.shape, generator=generator)
                / np.sqrt(fan_in)
            )
            if mod.bias is not None:
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
        raise _not_ported("preprocessing 'cnn1d_s1'", "item 7, other backbones")
    else:
        raise ValueError(f"Unknown preprocessing type {prep_type}")

    bconf = configs["backbone"]
    btype = bconf["type"]
    dtype = configs.get("dtype")
    if dtype and dtype != "float32":
        raise _not_ported(f"model dtype {dtype!r}", "item 15, training knobs")
    for knob in ("bn_dtype", "remat"):
        if bconf.get(knob):
            raise _not_ported(f"backbone.{knob}", "item 15, training knobs")
    if int(bconf.get("ghost_bn", 0) or 0) > 1:
        raise _not_ported("backbone.ghost_bn > 1", "item 15, training knobs")
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
        )
    elif btype in ("tcn", "fsmn", "gru"):
        raise _not_ported(f"backbone '{btype}'", "item 7, other backbones")
    else:
        raise ValueError(f"Unknown backbone type {btype}")

    if "classifier" in configs:
        ctype = configs["classifier"]["type"]
        if ctype == "element":
            classifier = ElementClassifier(
                hidden_dim, output_dim, configs["classifier"].get("dropout", 0.1)
            )
        elif ctype == "identity":
            classifier = IdentityClassifier()
        elif ctype in ("global", "last"):
            raise _not_ported(f"classifier '{ctype}'",
                              "item 6, the training slice's close (CE heads)")
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
