"""Export a checkpoint as a reference (wenet-e2e/wekws) PyTorch .pt.

Port of wekws_tpu/bin/export_torch.py, the inverse of
bin/import_torch.py: models trained with either package load directly
into the reference's score/export_onnx/runtime tooling (torch.load +
load_state_dict on its init_model(configs)).  The port's own ``.pt``
already carries the reference names; tools/export_torch.py says what
it checks and changes.

    python -m wekws_tpu_torch.bin.export_torch \\
        --checkpoint exp/avg_5.pt --config exp/config.yaml \\
        --output exp/avg_5_torch.pt
"""

import argparse

import yaml


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="export a checkpoint as a reference torch .pt"
    )
    parser.add_argument("--checkpoint", required=True,
                        help="a port .pt or a JAX-package .ckpt")
    parser.add_argument("--config", required=True,
                        help="resolved training config (model section)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default="cuda",
                        help="where the loaded model is checked: cuda "
                             "(default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the output path."""
    args = get_args(argv)
    from wekws_tpu_torch.tools.export_torch import export_torch_file

    with open(args.config) as f:
        configs = yaml.safe_load(f)
    export_torch_file(args.checkpoint, configs["model"], args.output,
                      args.device)
    print(f"exported -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
