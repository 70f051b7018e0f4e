"""Utterance classification accuracy CLI (the speech-commands path).

Port of wekws_tpu/bin/compute_accuracy.py: a port ``.pt`` or a
JAX-package ``.ckpt`` of a CE model (``global``, ``last`` head) scored
on the test list, on the card through ``bin.common.make_forward_fn``'s
route (the fused serving kernel for MDTC, DS-TCN and FSMN; the modules
for GRU and full-conv TCN), or with ``--device cpu`` the modules.
Prints ``Accuracy: {acc:.6f} ({correct}/{total})`` as the JAX CLI does.
"""

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="compute accuracy")
    parser.add_argument("--config", required=True)
    parser.add_argument("--test_data", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """-> (correct, total)."""
    args = get_args(argv)
    from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.eval import accuracy_over_dataset

    device = resolve_device(args.device)
    _, model, pipeline, test_conf = load_test_setup(
        args.config, args.checkpoint, args.batch_size, device
    )
    dataset = init_dataset(
        args.test_data, test_conf, split="test", rank=0, world_size=1
    )
    forward = make_forward_fn(model, pipeline, device)
    correct, total = accuracy_over_dataset(forward, dataset)
    acc = correct / max(total, 1)
    print(f"Accuracy: {acc:.6f} ({correct}/{total})")
    return correct, total


if __name__ == "__main__":
    main()
