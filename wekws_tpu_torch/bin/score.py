"""Posterior-trajectory scoring CLI (max-pooling path).

Port of wekws_tpu/bin/score.py (the reference wekws's bin/score.py):
a port ``.pt`` or a JAX-package ``.ckpt`` scored on the test list,
through the fused serving kernel on the card (module route with
``--device cpu``).
"""

import argparse
import os


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="compute posterior scores")
    parser.add_argument("--config", required=True)
    parser.add_argument("--test_data", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--score_file", required=True)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--dict", dest="dict_dir", default=None,
                        help="dict dir for keyword display names")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.eval import write_score_file

    device = resolve_device(args.device)
    configs, model, pipeline, test_conf = load_test_setup(
        args.config, args.checkpoint, args.batch_size, device
    )
    dataset = init_dataset(
        args.test_data, test_conf, split="test", rank=0, world_size=1
    )
    num_keywords = configs["model"]["output_dim"]
    if args.dict_dir is not None:
        from wekws_tpu_torch.text import read_token

        table = read_token(os.path.join(args.dict_dir, "dict.txt"))
        inv = {v: k for k, v in table.items()}
        names = [inv.get(i, str(i)) for i in range(num_keywords)]
    else:
        names = [str(i) for i in range(num_keywords)]
    forward = make_forward_fn(model, pipeline, device)
    n = write_score_file(forward, dataset, names, args.score_file)
    print(f"scored {n} utterances -> {args.score_file}")
    return n


if __name__ == "__main__":
    main()
