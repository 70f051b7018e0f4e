"""Config and model loading shared by the serving engines.

The loading half of wekws_tpu/runtime/keyword_spotter.py.  A port
checkpoint is ``torch.save`` of the model's state_dict, with the
reference wekws parameter names (tools/from_jax.py converts a JAX
checkpoint).  The single-stream CTC engine and the graph-artifact
loader are not ported yet.
"""

import dataclasses
import logging

import torch
import yaml

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.frontend.features import frontend_from_dataset_conf
from wekws_tpu_torch.models.kws_model import init_model


def load_spotter_config(config):
    """Resolved train config (dict or YAML path) -> (configs, frontend
    cfg without dither, left, right, frame_skip)."""
    if isinstance(config, dict):
        configs = config
    else:
        with open(config, "r") as fin:
            configs = yaml.safe_load(fin)
    dataset_conf = configs["dataset_conf"]
    cfg = dataclasses.replace(frontend_from_dataset_conf(dataset_conf).cfg,
                              dither=0.0)
    downsampling = int(dataset_conf.get("frame_skip", 1))
    left = right = 0
    if dataset_conf.get("context_expansion", False):
        ce = dataset_conf["context_expansion_conf"]
        left, right = ce.get("left", 0), ce.get("right", 0)
    return configs, cfg, left, right, downsampling


def load_serving_model(configs: dict, ckpt_path: str, feat_dim: int,
                       device="cuda"):
    """Build the model from ``configs['model']``, load a port
    checkpoint, and return it in eval mode on ``device``."""
    device = resolve_device(device)
    model_conf = configs["model"]
    if model_conf["input_dim"] != feat_dim:
        raise ValueError(
            f"model input_dim {model_conf['input_dim']} != frontend "
            f"feature dim {feat_dim}"
        )
    model = init_model(model_conf)
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    logging.info("model %s loaded.", ckpt_path)
    return model.to(device).eval()
