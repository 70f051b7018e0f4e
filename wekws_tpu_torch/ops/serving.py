"""Fused serving forward: KWSModel inference around a fused backbone.

Port of wekws_tpu/ops/serving.py.  The KWSModel forward (cmvn ->
preprocessing -> backbone -> classifier -> activation) is rebuilt
around the whole-backbone kernel ``fused_mdtc_forward`` /
``fused_mdtc_stream`` (ops/fused_mdtc.py).  Supported heads: linear
(wake word), identity (CTC), element MLP; for another head or an MDTC
without linear preprocessing the builders return None, as the JAX
package's do.  The FSMN and DS-TCN kernels are not ported yet, so any
other backbone raises.

The builders copy the model's weights to ``device`` (CUDA unless the
caller asks for the CPU) and return functions that run there under
``torch.inference_mode``.
"""

from typing import Callable, Optional

import torch

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.models.classifier import (
    ElementClassifier,
    IdentityClassifier,
    LinearClassifier,
)
from wekws_tpu_torch.models.kws_model import KWSModel, mask_padding
from wekws_tpu_torch.models.mdtc import MDTC
from wekws_tpu_torch.models.subsampling import LinearSubsampling1
from wekws_tpu_torch.ops.fused_mdtc import (
    extract_mdtc_weights,
    fused_mdtc_forward,
    fused_mdtc_stream,
    init_stream_cache,
)


def _f32(t, device):
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _head_weights(clf, device):
    """Classifier -> [(W (in, out), b, act)] or None when unsupported."""
    if isinstance(clf, LinearClassifier):
        return [(_f32(clf.linear.weight.t(), device),
                 _f32(clf.linear.bias, device), "none")]
    if isinstance(clf, ElementClassifier):
        fc1, fc2 = clf.classifier[0], clf.classifier[3]
        return [
            (_f32(fc1.weight.t(), device), _f32(fc1.bias, device), "relu"),
            (_f32(fc2.weight.t(), device), _f32(fc2.bias, device), "none"),
        ]
    if isinstance(clf, IdentityClassifier):
        return []
    return None


def _cmvn_weights(model, device):
    cmvn = model.global_cmvn
    if cmvn is None:
        return None, None
    mean = _f32(cmvn.mean, device)
    istd = _f32(cmvn.istd, device) if cmvn.norm_var else torch.ones_like(mean)
    return mean, istd


def _prep_weights(model, device):
    """(W (in, out), b) of the linear preprocessing, or None."""
    prep = model.preprocessing
    if not isinstance(prep, LinearSubsampling1):
        return None
    lin = prep.out[0]
    return _f32(lin.weight.t(), device), _f32(lin.bias, device)


def _make_runner(model, device, backbone_fn, init_cache, softmax,
                 streaming):
    """Shared pipeline around a fused backbone.

    backbone_fn: (x (B,T,D), cache) -> (x', cache').  Returns
    ``forward(feats, lengths)`` or, when streaming,
    ``(step(feats, cache), init_cache)``; None when the head is
    unsupported or the preprocessing is not linear."""
    clf_head = _head_weights(model.classifier, device)
    prep = _prep_weights(model, device)
    if clf_head is None or prep is None:
        return None
    prep_w, prep_b = prep
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
        x = torch.relu(x @ prep_w + prep_b)
        x, cache = backbone_fn(x.contiguous(), cache)
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
        out, _ = run(feats, None, lengths)
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
        return init_stream_cache(len(dilations), batch, pad_max, channels,
                                 device)

    return _make_runner(model, device, backbone_fn, init_cache, softmax,
                        streaming)


def _dispatch(model, softmax, streaming, device):
    device = resolve_device(device)
    if not isinstance(model.backbone, MDTC):
        raise NotImplementedError(
            f"no fused serving kernel for {type(model.backbone).__name__}: "
            "the FSMN and DS-TCN kernels (wekws_tpu/ops/fused_fsmn.py, "
            "fused_tcn.py) are not ported yet (ROADMAP queue B)"
        )
    return _build_fused_mdtc(model, device, softmax, streaming)


def build_fused_forward(
    model: KWSModel, softmax: bool = False, device="cuda"
) -> Optional[Callable]:
    """-> f(feats (B,T,D), lengths (B,)) -> posteriors (B,T,K) on
    ``device``, or None when the model shape isn't supported."""
    return _dispatch(model, softmax, streaming=False, device=device)


def build_fused_stream(model: KWSModel, softmax: bool = False,
                       device="cuda"):
    """Streaming fused apply for the serving engines.

    -> (step_fn(feats (B,T,D), cache) -> (posteriors, cache'),
        init_cache_fn(batch) -> cache) or None when unsupported.
    The cache is the packed (L, B, pad_max, C) fused-kernel context,
    not the module's tuple cache."""
    return _dispatch(model, softmax, streaming=True, device=device)
