"""Import a reference (wenet-e2e/wekws) PyTorch checkpoint: the port of
wekws_tpu/tools/import_torch.py.

The port's modules carry the reference names and layouts, so the
import is mostly a check: the state_dict (unwrapped from a
``{"state_dict": ...}`` file, ``module.`` prefixes removed) must load
strictly into the port's ``init_model`` of the config, whose model then
steps one zero chunk on ``device`` (the card unless the caller asks for
the CPU).  ``global_cmvn`` buffers in the file are returned beside the
state (the JAX package keeps CMVN in the config, and its CLI writes
them to ``<output>.cmvn.json``); a model whose config names CMVN takes
the file's buffers where it carries them, else its own from the config.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def read_reference_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` -> its state_dict of CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", "", 1): v for k, v in sd.items()}


def import_torch_state_dict(
    state_dict: Dict[str, torch.Tensor], model_conf: dict, device="cuda",
) -> Tuple[Dict[str, torch.Tensor], Optional[Tuple[np.ndarray,
                                                   np.ndarray]]]:
    """A reference state_dict -> (the port state_dict, on the CPU, and
    ``(mean, istd)`` when the file carries CMVN buffers, else None)."""
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.models.kws_model import inference_model_conf

    device = resolve_device(device)
    sd = dict(state_dict)
    cmvn = None
    if "global_cmvn.mean" in sd:
        cmvn = (sd.pop("global_cmvn.mean").float().numpy(),
                sd.pop("global_cmvn.istd").float().numpy())
    conf = inference_model_conf(model_conf)
    model = init_model(conf)
    if model.global_cmvn is not None:
        own = model.global_cmvn
        sd["global_cmvn.mean"], sd["global_cmvn.istd"] = (
            (torch.from_numpy(cmvn[0]), torch.from_numpy(cmvn[1]))
            if cmvn is not None else (own.mean, own.istd))
    model.load_state_dict(sd)  # strict: every key, every shape
    model = model.to(device).eval()
    with torch.inference_mode():
        model(torch.zeros((1, 8, conf["input_dim"]), device=device))
    return {k: v.detach().to("cpu") for k, v in model.state_dict().items()}, \
        cmvn


def import_torch_file(path: str, model_conf: dict, device="cuda"):
    """Load a reference ``.pt`` file and convert it."""
    return import_torch_state_dict(read_reference_file(path), model_conf,
                                   device)
