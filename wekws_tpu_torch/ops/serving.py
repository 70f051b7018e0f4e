"""Fused serving forward: KWSModel inference around a fused backbone.

Port of wekws_tpu/ops/serving.py.  The KWSModel forward (cmvn ->
preprocessing -> backbone -> classifier -> activation) is rebuilt
around a whole-backbone kernel: ``fused_mdtc_forward`` /
``fused_mdtc_stream`` (ops/fused_mdtc.py), ``fused_fsmn_layers``
(ops/fused_fsmn.py) or ``fused_ds_tcn`` (ops/fused_tcn.py).  Supported
heads: linear (wake word), identity (CTC), element MLP, and for a
whole-utterance forward the pooled CE heads: ``global`` (the mean over
each row's valid frames) and ``last`` (its last valid frame), then the
MLP.  The pooled heads are a departure from the JAX package, whose
builders give None for them; the pooling takes ``lengths`` because the
kernel's outputs at padded frames are not zero.  ``build_fused_stream``
gives None for a pooled head (it has no streaming form), and as in the
JAX package the builders give None for an MDTC or DS-TCN without linear
preprocessing and for a full-conv TCN (its (K, C, C) kernels are K
matmuls per layer and stay on the module path).  Any other backbone
(GRU) raises, where the JAX package returns None;
``has_serving_kernel`` says which backbones have a kernel and
``forward_route`` which route a loaded model takes.

Each ``_build_fused_*`` only supplies a ``backbone_fn(x, cache)`` and a
cache constructor; the surrounding pipeline (padding mask, cmvn, linear
preprocessing, head, sigmoid/softmax) is shared in ``_make_runner``.

The builders copy the model's weights to ``device`` (CUDA unless the
caller asks for the CPU) and return functions that run there under
``torch.inference_mode``.
"""

from typing import Callable, Dict, Optional

import torch

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.models.classifier import (
    ElementClassifier,
    GlobalClassifier,
    IdentityClassifier,
    LastClassifier,
    LinearClassifier,
)
from wekws_tpu_torch.models.fsmn import FSMN
from wekws_tpu_torch.models.kws_model import KWSModel, mask_padding
from wekws_tpu_torch.models.mdtc import MDTC
from wekws_tpu_torch.models.subsampling import LinearSubsampling1, NoSubsampling
from wekws_tpu_torch.models.tcn import TCN
from wekws_tpu_torch.ops.fused_frontend import fused_fbank
from wekws_tpu_torch.ops.fused_fsmn import (
    extract_fsmn_weights,
    fused_fsmn_layers,
    init_fsmn_cache,
    pack_fsmn_weights,
)
from wekws_tpu_torch.ops.fused_mdtc import (
    extract_mdtc_weights,
    fused_mdtc_forward,
    fused_mdtc_stream,
    init_stream_cache,
)
from wekws_tpu_torch.ops.fused_tcn import (
    extract_ds_tcn_weights,
    fused_ds_tcn,
    init_tcn_cache,
)


def _f32(t, device):
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _head_weights(clf, device):
    """Classifier -> (pool, [(W (in, out), b, act)]) or None when
    unsupported; ``pool`` is None for a per-frame head, else the
    head's ``pool(x (B, T, H), lengths) -> (B, H)``."""
    if isinstance(clf, LinearClassifier):
        return None, [(_f32(clf.linear.weight.t(), device),
                       _f32(clf.linear.bias, device), "none")]
    if isinstance(clf, (ElementClassifier, GlobalClassifier,
                        LastClassifier)):
        # fc1 -> ReLU -> (dropout, inactive in eval) -> fc2
        fc1, fc2 = clf.classifier[0], clf.classifier[3]
        return getattr(clf, "pool", None), [
            (_f32(fc1.weight.t(), device), _f32(fc1.bias, device), "relu"),
            (_f32(fc2.weight.t(), device), _f32(fc2.bias, device), "none"),
        ]
    if isinstance(clf, IdentityClassifier):
        return None, []
    return None


def _cmvn_weights(model, device):
    cmvn = model.global_cmvn
    if cmvn is None:
        return None, None
    mean = _f32(cmvn.mean, device)
    istd = _f32(cmvn.istd, device) if cmvn.norm_var else torch.ones_like(mean)
    return mean, istd


def _prep_weights(model, device):
    """-> ((W (in, out), b) | (None, None), ok) for the preprocessing."""
    prep = model.preprocessing
    if isinstance(prep, LinearSubsampling1):
        lin = prep.out[0]
        return (_f32(lin.weight.t(), device), _f32(lin.bias, device)), True
    if isinstance(prep, NoSubsampling):
        return (None, None), True
    return (None, None), False


def _make_runner(model, device, backbone_fn, init_cache, softmax,
                 streaming, *, require_linear_prep=False):
    """Shared pipeline around a fused backbone.

    backbone_fn: (x (B,T,D), cache) -> (x', cache').  The
    whole-utterance MDTC passes its cache (None) through untouched; the
    others start from ``init_cache``.  Returns ``forward(feats,
    lengths)`` or, when streaming, ``(step(feats, cache), init_cache)``;
    None when the head or the preprocessing is unsupported, and for a
    pooled head when streaming."""
    head = _head_weights(model.classifier, device)
    if head is None:
        return None
    pool, clf_head = head
    if pool is not None and streaming:
        return None
    (prep_w, prep_b), prep_ok = _prep_weights(model, device)
    if not prep_ok or (require_linear_prep and prep_w is None):
        return None
    cmvn_mean, cmvn_istd = _cmvn_weights(model, device)
    sigmoid = model.activation == "sigmoid"

    @torch.inference_mode()
    def run(x, cache, lengths=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=device)
        if not streaming:
            x = mask_padding(x, lengths)
        if cmvn_mean is not None:
            x = (x - cmvn_mean) * cmvn_istd
            if not streaming:
                x = mask_padding(x, lengths)
        if prep_w is not None:
            x = torch.relu(x @ prep_w + prep_b)
        x, cache = backbone_fn(x.contiguous(), cache)
        if pool is not None:
            x = pool(x, lengths)
        for wgt, bias, act in clf_head:
            x = x @ wgt + bias
            if act == "relu":
                x = torch.relu(x)
        if sigmoid:
            x = torch.sigmoid(x)
        if softmax:
            x = torch.softmax(x, dim=-1)
        return x, cache

    if streaming:
        return run, init_cache

    def forward(feats, lengths=None):
        out, _ = run(feats, init_cache(len(feats)), lengths)
        return out

    return forward


def _build_fused_mdtc(model, device, softmax, streaming):
    """Forward/step builder for the fused MDTC path."""
    weights = extract_mdtc_weights(model.backbone)
    dilations = weights[-1]
    dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b = (
        _f32(w, device) for w in weights[:-1]
    )
    kern = model.backbone.kernel_size
    stack_size = model.backbone.stack_size
    pad_max = (kern - 1) * max(dilations)
    channels = model.backbone.res_channels

    if streaming:
        def backbone_fn(x, cache):
            return fused_mdtc_stream(
                x, cache, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b,
                dilations, kern, stack_size,
            )
    else:
        def backbone_fn(x, cache):
            # whole-utterance kernel: zero left context, no cache
            out = fused_mdtc_forward(
                x, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b,
                dilations, kern, stack_size,
            )
            return out, cache

    def init_cache(batch: int = 1):
        if not streaming:
            return None
        return init_stream_cache(len(dilations), batch, pad_max, channels,
                                 device)

    return _make_runner(model, device, backbone_fn, init_cache, softmax,
                        streaming, require_linear_prep=True)


def _build_fused_fsmn(model, device, softmax, streaming):
    """Forward/step for the fused FSMN path: the in/out linear pairs
    are matmuls around the layer-chain kernel."""
    fsmn = model.backbone
    (in1_w, in1_b, in2_w, in2_b, proj_w, wl, wr, aff_w, aff_b,
     out1_w, out1_b, out2_w, out2_b) = (
        _f32(w, device) for w in extract_fsmn_weights(fsmn))
    # each block's slices as contiguous runs, for the kernel's copy engine
    packed = pack_fsmn_weights(proj_w, aff_w)

    def backbone_fn(x, cache):
        x = torch.relu((x @ in1_w + in1_b) @ in2_w + in2_b)
        x, cache = fused_fsmn_layers(
            x.contiguous(), cache, proj_w, wl, wr, aff_w, aff_b,
            fsmn.lorder, fsmn.rorder, fsmn.lstride, fsmn.rstride,
            packed=packed)
        x = (x @ out1_w + out1_b) @ out2_w + out2_b
        return x, cache

    def init_cache(batch: int = 1):
        return init_fsmn_cache(fsmn.fsmn_layers, batch, fsmn.layer_padding,
                               fsmn.proj_dim, device)

    return _make_runner(model, device, backbone_fn, init_cache, softmax,
                        streaming)


def _build_fused_tcn(model, device, softmax, streaming):
    """Forward/step for the fused DS-TCN path."""
    if not model.backbone.ds:
        return None  # full-conv blocks stay on the module path
    weights = extract_ds_tcn_weights(model.backbone)
    dilations = weights[-1]
    dw_w, dw_b, pw_w, pw_b = (_f32(w, device) for w in weights[:-1])
    kern = model.backbone.kernel_size
    pad_max = (kern - 1) * max(dilations)
    channels = model.backbone.channel

    def backbone_fn(x, cache):
        return fused_ds_tcn(x, cache, dw_w, dw_b, pw_w, pw_b, dilations,
                            kern)

    def init_cache(batch: int = 1):
        return init_tcn_cache(len(dilations), batch, pad_max, channels,
                              device)

    return _make_runner(model, device, backbone_fn, init_cache, softmax,
                        streaming, require_linear_prep=True)


_BUILDERS = (
    (FSMN, _build_fused_fsmn),
    (TCN, _build_fused_tcn),
    (MDTC, _build_fused_mdtc),
)


def has_serving_kernel(model: KWSModel) -> bool:
    """Whether the model's backbone has a serving kernel (one in the
    JAX package too): MDTC, DS-TCN and FSMN.  A GRU or full-conv TCN
    has none and runs as modules; the builders may still refuse a
    backbone that has one, for its preprocessing or head."""
    backbone = model.backbone
    if isinstance(backbone, TCN) and not backbone.ds:
        return False  # full-conv blocks (``_build_fused_tcn``)
    return any(isinstance(backbone, cls) for cls, _ in _BUILDERS)


def forward_route(model: KWSModel, device) -> str:
    """``"fused"`` on the card for a backbone with a serving kernel
    (``has_serving_kernel``), else ``"module"``: the route the CLIs and
    the serving engines take for a loaded model."""
    if torch.device(device).type == "cuda" and has_serving_kernel(model):
        return "fused"
    return "module"


def launch_counts() -> Dict[str, int]:
    """The launches so far of each serving kernel's wrapper, by name."""
    return {fn.__name__: fn.launches for fn in (
        fused_fbank, fused_mdtc_forward, fused_mdtc_stream, fused_ds_tcn,
        fused_fsmn_layers)}


def _dispatch(model, softmax, streaming, device):
    device = resolve_device(device)
    for cls, build in _BUILDERS:
        if isinstance(model.backbone, cls):
            return build(model, device, softmax, streaming)
    raise NotImplementedError(
        f"no fused serving kernel for {type(model.backbone).__name__}")


def build_fused_forward(
    model: KWSModel, softmax: bool = False, device="cuda"
) -> Optional[Callable]:
    """-> f(feats (B,T,D), lengths (B,)) -> posteriors (B,T,K), or
    logits (B,K) for a pooled head, on ``device``; None when the model
    shape isn't supported."""
    return _dispatch(model, softmax, streaming=False, device=device)


def build_fused_stream(model: KWSModel, softmax: bool = False,
                       device="cuda"):
    """Streaming fused apply for the serving engines.

    -> (step_fn(feats (B,T,D), cache) -> (posteriors, cache'),
        init_cache_fn(batch) -> cache) or None when unsupported.
    The cache is the packed (L, B, pad_max, C) fused-kernel context,
    not the module's tuple cache."""
    return _dispatch(model, softmax, streaming=True, device=device)
