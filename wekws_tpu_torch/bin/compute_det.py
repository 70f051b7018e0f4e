"""DET curve CLI (max-pooling path).

Port of wekws_tpu/bin/compute_det.py (the reference wekws's
bin/compute_det.py).  The sweep is host work; ``--device`` is checked
as for every entry point of the port.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="compute det curve")
    parser.add_argument("--test_data", required=True, help="label file")
    parser.add_argument("--keyword", required=True, help="keyword label")
    parser.add_argument("--score_file", required=True)
    parser.add_argument("--step", type=float, default=0.01)
    parser.add_argument("--window_shift", type=int, default=50)
    parser.add_argument("--stats_file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.eval import (
        compute_det,
        load_label_and_score,
        write_stats_file,
    )

    resolve_device(args.device)
    keyword_table, filler_table, filler_duration = load_label_and_score(
        args.keyword, args.test_data, args.score_file
    )
    print(f"Filler total duration Hours: {filler_duration / 3600.0}")
    results = compute_det(
        keyword_table, filler_table, filler_duration,
        step=args.step, window_shift=args.window_shift,
    )
    write_stats_file(results, args.stats_file)
    return results


if __name__ == "__main__":
    main()
