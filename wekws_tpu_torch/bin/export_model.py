"""Model export CLI with parity gates.

Port of wekws_tpu/bin/export_model.py (``--format graph``): the
portable graph artifact of export/graph.py, the format the C++
streaming runtime (runtime/) and the serving engines read, from a port
``.pt`` or a JAX-package ``.ckpt``.  Two gates follow the export:

* the artifact through the numpy runtime (the C++ runtime's executable
  specification) against the port model's float32 forward on the CPU,
  on ``default_rng(0)`` features ``(1, 100, input_dim)``: max abs error
  below 1e-3, the JAX CLI's gate (the reference's ONNX parity check);
* the artifact through ``TorchGraphRuntime`` on ``--device`` (the card
  by default) against the numpy runtime on the same features, within
  the same 1e-3.

``--format stablehlo`` is an XLA serialization of the jitted cached
step; its PyTorch counterpart (a ``torch.export`` of the module
route's cached step) is not ported (ROADMAP A.18) and raises.

    python -m wekws_tpu_torch.bin.export_model --config exp/config.yaml \\
        --checkpoint exp/avg_5.pt --output_dir exp/export
"""

import argparse

import numpy as np
import yaml

PARITY_ATOL = 1e-3


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="export model")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a port .pt or a JAX-package .ckpt")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--format", default="graph",
                        choices=["graph", "stablehlo"],
                        help="stablehlo: not ported (ROADMAP A.18)")
    parser.add_argument("--device", default="cuda",
                        help="where the device runtime's gate runs: cuda "
                             "(default) or cpu")
    return parser.parse_args(argv)


def export_model_conf(model_conf: dict) -> dict:
    """The model config the artifact is exported from: float32, so a
    training-time ``dtype`` and the backbone's ``bn_dtype`` are dropped
    (the artifact holds float32 weights, and the gate compares against
    exact float32 semantics)."""
    conf = {k: v for k, v in model_conf.items() if k != "dtype"}
    if isinstance(conf.get("backbone"), dict):
        conf["backbone"] = {k: v for k, v in conf["backbone"].items()
                            if k != "bn_dtype"}
    return conf


def main(argv=None):
    """Returns the two gates' max abs errors (numpy runtime vs model,
    device runtime vs numpy runtime)."""
    args = get_args(argv)
    import torch

    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.export import (
        GraphRuntime,
        TorchGraphRuntime,
        export_model,
    )
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.models.kws_model import _not_ported
    from wekws_tpu_torch.train.checkpoint import load_model_state

    if args.format == "stablehlo":
        raise _not_ported("--format stablehlo (a torch.export of the cached "
                          "step)", "item 18, export formats")
    device = resolve_device(args.device)
    with open(args.config) as f:
        configs = yaml.safe_load(f)
    model_conf = export_model_conf(configs["model"])
    model = init_model(model_conf)
    model.load_state_dict(load_model_state(args.checkpoint, model_conf,
                                           model))
    export_model(model, configs, args.output_dir)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 100, model_conf["input_dim"])).astype(
        np.float32)
    with torch.inference_mode():
        want, _ = model(torch.from_numpy(x))
    want = want.numpy()
    rt = GraphRuntime(args.output_dir)
    got, _ = rt.forward(x[0])
    if want.ndim == 3:
        got = got[None]
    err = float(np.abs(got - want).max())
    if not err < PARITY_ATOL:
        raise RuntimeError(f"export parity failed: max err {err} (numpy "
                           f"runtime vs the model's float32 forward)")
    dev_out, _ = TorchGraphRuntime(args.output_dir, device).forward(x)
    dev_out = dev_out.cpu().numpy()
    dev_err = float(np.abs(dev_out.reshape(got.shape) - got).max())
    if not dev_err < PARITY_ATOL:
        raise RuntimeError(f"export parity failed: max err {dev_err} "
                           f"(TorchGraphRuntime on {device} vs the numpy "
                           f"runtime)")
    print(f"graph artifact -> {args.output_dir} "
          f"(cache_len={rt.meta['cache_len']}, "
          f"cache_dim={rt.meta['cache_dim']}, parity max err {err:.2e}, "
          f"{device.type} runtime {dev_err:.2e})")
    return err, dev_err


if __name__ == "__main__":
    main()
