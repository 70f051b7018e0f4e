"""DET curve plotting CLI.

Port of wekws_tpu/bin/plot_det_curve.py (the reference wekws's
bin/plot_det_curve.py): FA/h (x) against FRR % (y), one curve per
keyword of ``words.txt`` (its first line skipped, as the recipes'
files start with the filler), from the ``stats.<keyword>.txt`` files of
``--stats_dir``.  matplotlib is optional (the ``plot`` extra) and
imported when the plot is drawn: without it the plot raises
``ImportError`` naming the extra (ROADMAP C.29).  The plot is host
work, so this CLI takes no ``--device``.

    python -m wekws_tpu_torch.bin.plot_det_curve --keywords_dict \\
        dict/words.txt --stats_dir exp/mdtc --figure_file exp/det.png
"""

import argparse
import os


def plot_det_curve(
    keywords, stats_dir, figure_file, xlim=5, x_step=1, ylim=35, y_step=5
):
    import numpy as np

    from wekws_tpu_torch.eval.det import import_pyplot

    plt = import_pyplot()
    plt.figure(dpi=200)
    plt.rcParams["font.size"] = 12

    for keyword in keywords:
        stats_file = os.path.join(stats_dir, "stats." + keyword + ".txt")
        values = []
        with open(stats_file, "r", encoding="utf8") as fin:
            for line in fin:
                arr = line.strip().split()
                values.append([float(arr[1]), float(arr[2]) * 100])
        values = np.array(values)
        values = values[np.argsort(values[:, 0])]
        plt.plot(values[:, 0], values[:, 1], label=keyword)

    plt.xlim([0, xlim])
    plt.ylim([0, ylim])
    plt.xticks(range(0, xlim + x_step, x_step))
    plt.yticks(range(0, ylim + y_step, y_step))
    plt.xlabel("False Alarm Per Hour")
    plt.ylabel("False Rejection Rate (%)")
    plt.grid(linestyle="--")
    plt.legend(loc="best", fontsize=16)
    plt.savefig(figure_file)
    plt.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description="plot det curve")
    parser.add_argument("--keywords_dict", required=True,
                        help="words.txt; first line skipped like the "
                             "reference recipes")
    parser.add_argument("--stats_dir", required=True)
    parser.add_argument("--figure_file", required=True)
    parser.add_argument("--xlim", type=int, default=5)
    parser.add_argument("--x_step", type=int, default=1)
    parser.add_argument("--ylim", type=int, default=35)
    parser.add_argument("--y_step", type=int, default=5)
    args = parser.parse_args(argv)

    with open(args.keywords_dict, encoding="utf8") as f:
        keywords = [line.strip().split()[0] for line in f if line.strip()][1:]
    plot_det_curve(
        keywords, args.stats_dir, args.figure_file,
        args.xlim, args.x_step, args.ylim, args.y_step,
    )
    return args.figure_file


if __name__ == "__main__":
    main()
