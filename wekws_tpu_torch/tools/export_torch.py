"""Export a checkpoint as a reference (wenet-e2e/wekws) PyTorch
state_dict: the port of wekws_tpu/tools/export_torch.py.

The port's modules already carry the reference names and layouts, so
the export is mostly a check and two edits of a port state_dict:
``num_batches_tracked`` is written as a one-element int64 0 (what the
JAX package writes; ``load_state_dict`` takes it for the 0-dim buffer)
and the ``global_cmvn`` buffers
only where the model config holds its CMVN statistics inline (as the
JAX package writes them; statistics from a ``cmvn_file`` stay in that
file).  The checkpoint is a port ``.pt`` or a JAX-package ``.ckpt``;
it must load strictly into the port's ``init_model`` of the config,
and the loaded model steps one chunk on ``device`` (the card unless the
caller asks for the CPU) before the file is written.
"""

from typing import Dict

import torch


def export_torch_state_dict(state_dict: Dict[str, torch.Tensor],
                            model_conf: dict) -> Dict[str, torch.Tensor]:
    """A port state_dict -> the reference state_dict (CPU float32
    tensors, ``num_batches_tracked`` int64 ``[0]``)."""
    inline_cmvn = (model_conf.get("cmvn", {}) or {}).get("mean") is not None
    out = {}
    for key, val in state_dict.items():
        if key.startswith("global_cmvn.") and not inline_cmvn:
            continue
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros(1, dtype=torch.int64)
        else:
            out[key] = val.detach().to("cpu", torch.float32).clone()
    return out


def load_port_model(checkpoint: str, model_conf: dict, device="cuda"):
    """The port model of ``model_conf`` holding a port ``.pt`` or a
    JAX-package ``.ckpt`` (strict load), eval mode on ``device``, after
    one zero chunk through it there."""
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.models.kws_model import inference_model_conf
    from wekws_tpu_torch.train.checkpoint import load_model_state

    device = resolve_device(device)
    conf = inference_model_conf(model_conf)
    model = init_model(conf)
    model.load_state_dict(load_model_state(checkpoint, conf, model))
    model = model.to(device).eval()
    with torch.inference_mode():
        model(torch.zeros((1, 8, conf["input_dim"]), device=device))
    return model


def export_torch_file(checkpoint_path: str, model_conf: dict,
                      output_path: str, device="cuda") -> None:
    """A port ``.pt`` or a JAX-package ``.ckpt`` -> a reference-loadable
    ``.pt``."""
    model = load_port_model(checkpoint_path, model_conf, device)
    torch.save(export_torch_state_dict(model.state_dict(), model_conf),
               output_path)
