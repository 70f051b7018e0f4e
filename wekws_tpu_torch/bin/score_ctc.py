"""CTC keyword scoring CLI.

Port of wekws_tpu/bin/score_ctc.py (the reference wekws's
bin/score_ctc.py): a port ``.pt`` or a JAX-package ``.ckpt`` scored on
the test list, the softmax posteriors through the fused serving kernel
on the card (``fused_fsmn_kernel`` for FSMN; the module route with
``--device cpu``), decoded by the host prefix beam search or, with
``--device_decode``, by the batched one on the same device.
"""

import argparse
import os


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="ctc keyword scoring")
    parser.add_argument("--config", required=True)
    parser.add_argument("--test_data", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--score_file", required=True)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--dict", dest="dict_dir", required=True)
    parser.add_argument("--keywords", required=True,
                        help="comma separated keywords")
    parser.add_argument("--score_beam_size", type=int, default=3)
    parser.add_argument("--path_beam_size", type=int, default=20)
    parser.add_argument("--device_decode", action="store_true",
                        help="batched prefix beam search on the device")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
    from wekws_tpu_torch.data import init_dataset
    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.eval import build_keywords_token, write_ctc_score_file
    from wekws_tpu_torch.text import CharTokenizer

    device = resolve_device(args.device)
    words = os.path.join(args.dict_dir, "words.txt")
    tokenizer = CharTokenizer(
        os.path.join(args.dict_dir, "dict.txt"),
        words if os.path.exists(words) else None,
        unk="<filler>",
        split_with_space=True,
    )
    keywords = [k for k in args.keywords.strip().replace(" ", "").split(",")
                if k]
    keywords_token, idxset = build_keywords_token(keywords, tokenizer)

    _, model, pipeline, test_conf = load_test_setup(
        args.config, args.checkpoint, args.batch_size, device
    )
    dataset = init_dataset(
        args.test_data, test_conf, tokenizer, split="test", rank=0,
        world_size=1,
    )
    forward = make_forward_fn(model, pipeline, device, softmax=True)
    n = write_ctc_score_file(
        forward, dataset, keywords_token, idxset, args.score_file,
        args.score_beam_size, args.path_beam_size,
        device_decode=args.device_decode, device=device,
    )
    print(f"scored {n} utterances -> {args.score_file}")
    return n


if __name__ == "__main__":
    main()
