"""Shared CLI plumbing: load a trained model and its config, batched
forward.

Port of wekws_tpu/bin/common.py.  The forward runs the device feature
pipeline, then the model by one of two routes, chosen from the model's
structure alone (``ops.serving.forward_route``):

- ``"fused"``: on the card, a backbone that has a serving kernel (MDTC,
  DS-TCN, FSMN; ``ops.serving.has_serving_kernel``) runs through
  ``build_fused_forward``.  A model of such a backbone that the
  builder does not cover (no linear preprocessing, an unsupported head)
  raises: nothing falls back to the module route.
- ``"module"``: the model's modules with eager PyTorch ops, on the CPU
  for every model and on the card for a backbone that has no kernel in
  the JAX package either (GRU, full-conv TCN), as the JAX CLI runs every
  model through ``model.apply``.  No hand kernel is on that route.

The returned forward carries its route as ``forward.route``.  The JAX
package's ``enable_compilation_cache`` has no counterpart.
"""

import copy
import logging

import numpy as np
import torch
import yaml

from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.models.kws_model import inference_model_conf
from wekws_tpu_torch.ops.serving import build_fused_forward, forward_route
from wekws_tpu_torch.train.checkpoint import load_model_state


def scoring_dataset_conf(dataset_conf: dict, batch_size: int) -> dict:
    """The test-time data settings: no length filter, ``batch_size``."""
    test_conf = copy.deepcopy(dataset_conf)
    fc = test_conf.get("filter_conf", {})
    fc["max_length"] = 102400
    fc["min_length"] = 0
    fc["min_output_input_ratio"] = 0.0
    fc["token_max_length"] = 10240
    fc["token_min_length"] = 1
    test_conf["filter_conf"] = fc
    test_conf["batch_conf"] = dict(
        test_conf.get("batch_conf", {}), batch_size=batch_size
    )
    return test_conf


def load_test_setup(config_path: str, checkpoint: str, batch_size: int,
                    device: torch.device):
    """-> (configs, model (eval, on ``device``), cv pipeline, test_conf).
    ``checkpoint`` is a port ``.pt`` or a JAX-package ``.ckpt``; the
    model is float32 whatever ``model.dtype`` says."""
    with open(config_path, "r") as fin:
        configs = yaml.safe_load(fin)
    test_conf = scoring_dataset_conf(configs["dataset_conf"], batch_size)
    pipeline = DeviceFeaturePipeline.from_conf(test_conf, training=False)
    model_conf = inference_model_conf(configs["model"])
    model = init_model(model_conf)
    model.load_state_dict(load_model_state(checkpoint, model_conf, model))
    return configs, model.to(device).eval(), pipeline, test_conf


def make_forward_fn(model, pipeline: DeviceFeaturePipeline,
                    device: torch.device, softmax: bool = False):
    """batch dict -> (posteriors numpy (B, T, K), or logits (B, K) for a
    pooled head; feat lengths numpy).  ``forward.route`` is
    ``forward_route(model, device)``."""
    route = forward_route(model, device)
    logging.info("scoring route: %s (%s backbone, %s, %s)", route,
                 type(model.backbone).__name__,
                 type(model.classifier).__name__, device)
    if route == "fused":
        apply = build_fused_forward(model, softmax=softmax, device=device)
        if apply is None:
            raise NotImplementedError(
                f"no fused serving kernel covers this model "
                f"({type(model.backbone).__name__} backbone, "
                f"{type(model.preprocessing).__name__}, "
                f"{type(model.classifier).__name__}); score it with "
                f"--device cpu")
    else:
        def apply(feats, lengths):
            return model(feats, lengths=lengths, softmax=softmax)[0]

    @torch.inference_mode()
    def forward(batch):
        waves = torch.as_tensor(np.asarray(batch["waves"])).to(
            device, torch.float32)
        lengths = torch.as_tensor(np.asarray(batch["wave_lengths"])).to(
            device, torch.int64)
        feats, feat_lengths = pipeline(waves, lengths)
        out = apply(feats, feat_lengths)
        return out.cpu().numpy(), feat_lengths.cpu().numpy()

    forward.route = route
    return forward
