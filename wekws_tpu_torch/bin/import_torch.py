"""Convert a reference (wenet-e2e/wekws) PyTorch checkpoint into a
port checkpoint.

Port of wekws_tpu/bin/import_torch.py:

    python -m wekws_tpu_torch.bin.import_torch \\
        --torch_checkpoint avg_30.pt --config config.yaml \\
        --output_checkpoint exp/imported.pt

The config is the (reference-compatible) training config whose
``model`` section describes the checkpoint's architecture.  The port's
``.pt`` carries the reference names, so the import checks that the
file loads strictly into the port's model (tools/import_torch.py) and
writes its state.  If the checkpoint embeds GlobalCMVN buffers they
are also written next to the output as ``<output>.cmvn.json`` with
inline ``{mean, istd}`` stats (for the model config's ``cmvn`` entry).
The converted checkpoint flows through the port's score/DET,
export_model, static_quantize and serving paths.
"""

import argparse
import json

import yaml


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="import a reference torch checkpoint"
    )
    parser.add_argument("--torch_checkpoint", required=True)
    parser.add_argument("--config", required=True,
                        help="training config (model section)")
    parser.add_argument("--output_checkpoint", required=True)
    parser.add_argument("--device", default="cuda",
                        help="where the loaded model is checked: cuda "
                             "(default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the output checkpoint's path."""
    args = get_args(argv)
    from wekws_tpu_torch.tools.import_torch import import_torch_file
    from wekws_tpu_torch.train.checkpoint import save_checkpoint

    with open(args.config) as f:
        configs = yaml.safe_load(f)
    state, cmvn = import_torch_file(args.torch_checkpoint, configs["model"],
                                    args.device)
    save_checkpoint(args.output_checkpoint, state)
    msg = f"imported -> {args.output_checkpoint}"
    if cmvn is not None:
        cmvn_path = args.output_checkpoint + ".cmvn.json"
        with open(cmvn_path, "w") as f:
            json.dump({"mean": cmvn[0].tolist(),
                       "istd": cmvn[1].tolist()}, f)
        msg += f" (+ {cmvn_path})"
    print(msg)
    return args.output_checkpoint


if __name__ == "__main__":
    main()
