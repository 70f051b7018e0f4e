"""DET curve CLI (CTC path).

Port of wekws_tpu/bin/compute_det_ctc.py (the reference wekws's
bin/compute_det_ctc.py): one ``stats.<keyword>.txt`` per keyword, then
with ``--figure_file`` the overlaid DET plot of the stats directory
(``eval/det_ctc.plot_det_curves``; matplotlib, the optional ``plot``
extra, is imported only then, after the stats files are written:
ROADMAP C.29).  The sweep is host work; ``--device`` is checked as for
every entry point of the port.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="compute ctc det curve")
    parser.add_argument("--test_data", required=True)
    parser.add_argument("--keywords", required=True,
                        help="comma separated keywords")
    parser.add_argument("--score_file", required=True)
    parser.add_argument("--step", type=float, default=0.001)
    parser.add_argument("--stats_dir", default=None)
    parser.add_argument("--figure_file", default=None,
                        help="write an overlaid DET plot (legend labels "
                             "romanized via pypinyin when installed; needs "
                             "matplotlib)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from wekws_tpu_torch.device import resolve_device
    from wekws_tpu_torch.eval import (
        compute_det_ctc,
        load_label_and_score_ctc,
        space_mixed_label,
        write_stats_file,
    )

    resolve_device(args.device)
    keywords = [k for k in args.keywords.strip().replace(" ", "").split(",")
                if k]
    table = load_label_and_score_ctc(keywords, args.test_data,
                                     args.score_file)
    stats_dir = args.stats_dir or os.path.dirname(args.score_file)
    stats_files = []
    for keyword in keywords:
        norm_kw = space_mixed_label(keyword)
        entry = table[norm_kw]
        print(
            f"{keyword}: {len(entry['keyword_table'])} keyword utts "
            f"({entry['keyword_duration'] / 3600.0:.3f} h), filler "
            f"{entry['filler_duration'] / 3600.0:.3f} h"
        )
        results = compute_det_ctc(entry, step=args.step)
        stats_files.append(os.path.join(
            stats_dir, "stats." + norm_kw.replace(" ", "_") + ".txt"))
        write_stats_file(results, stats_files[-1])

    if args.figure_file:
        from wekws_tpu_torch.eval.det_ctc import plot_det_curves

        plot_det_curves(stats_dir, args.figure_file)
    return stats_files


if __name__ == "__main__":
    main()
