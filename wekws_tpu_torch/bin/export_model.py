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

``--format stablehlo`` keeps the JAX CLI's name, so the recipes call
the same command, but writes ``<output_dir>/model.pt2``: a
``torch.export`` program of the module route's cached step,
``model(feats, cache, softmax=False)`` at a static ``(1, --chunk_frames,
input_dim)`` chunk (``export/cached_step.py``; ROADMAP C.28: StableHLO
is XLA's format).  It is traced on ``--device`` and loaded back there,
and the loaded program is held against the eager cached step over three
chunks carried from the initial cache, on ``default_rng(0)`` features,
within 1e-5 abs + 1e-5 rel.

    python -m wekws_tpu_torch.bin.export_model --config exp/config.yaml \\
        --checkpoint exp/avg_5.pt --output_dir exp/export
    python -m wekws_tpu_torch.bin.export_model --config exp/config.yaml \\
        --checkpoint exp/avg_5.pt --output_dir exp/export \\
        --format stablehlo --chunk_frames 32
"""

import argparse
import os

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
                        help="graph: the artifact of export/graph.py; "
                             "stablehlo: model.pt2, a torch.export "
                             "program of the module route's cached step "
                             "(the fused kernels are not traced)")
    parser.add_argument("--chunk_frames", type=int, default=32,
                        help="stablehlo: static frames per step")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the device "
                             "runtime's gate runs (graph), where the step "
                             "is traced and checked (stablehlo)")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the two gates' max abs errors (numpy runtime vs model,
    device runtime vs numpy runtime); for ``--format stablehlo`` the
    program's against the eager step."""
    args = get_args(argv)
    import torch

    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.export import (
        GraphRuntime,
        TorchGraphRuntime,
        export_model,
    )
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.models.kws_model import inference_model_conf
    from wekws_tpu_torch.train.checkpoint import load_model_state

    device = resolve_device(args.device)
    with open(args.config) as f:
        configs = yaml.safe_load(f)
    model_conf = inference_model_conf(configs["model"])
    model = init_model(model_conf)
    model.load_state_dict(load_model_state(args.checkpoint, model_conf,
                                           model))
    if args.format == "stablehlo":
        return export_step(model, args.chunk_frames, args.output_dir, device)
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


def export_step(model, chunk_frames, output_dir, device):
    """``--format stablehlo``: the cached step exported on ``device``,
    saved as ``output_dir/model.pt2``, loaded back and held against the
    eager step.  Returns the gate's max abs error."""
    import torch

    from wekws_tpu_torch.export.cached_step import (
        GATE_CHUNKS,
        aten_op_counts,
        check_cached_step,
        export_cached_step,
        load_cached_step,
    )

    program = export_cached_step(model, chunk_frames, device)
    n_ops = sum(aten_op_counts(program).values())
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, "model.pt2")
    torch.export.save(program, out)
    err = check_cached_step(load_cached_step(out, device), model,
                            chunk_frames, device)
    print(f"cached step (torch.export, {n_ops} aten ops, chunk "
          f"{chunk_frames} frames) -> {out} (program vs the eager step "
          f"over {GATE_CHUNKS} chunks on {device.type}: max err {err:.2e})")
    return err


if __name__ == "__main__":
    main()
