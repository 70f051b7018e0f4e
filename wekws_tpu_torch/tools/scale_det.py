"""The scale recipe's DET at its lowest false-alarm rates, over training
seeds (``examples/synthetic_scale``, 10 filler hours in its test set).

    # on the card: the corpus and CMVN once, then each seed's training and
    # scoring (``run_torch.sh`` stages 2-3 with TRAIN_SEED) side by side;
    # the score files gzipped into --out
    python -m wekws_tpu_torch.tools.scale_det run --work DIR \
        --seeds 666,667 --out chiprun_out/scale_det
    # anywhere (the CPU will do): the DET of each score file at --step,
    # FRR at 0.1 and 1.0 FA/h, and the false alarms' scores
    python -m wekws_tpu_torch.tools.scale_det report \
        --out chiprun_out/scale_det [--step 0.001]
    # the CPU: each seed's initial model, its mean posterior in training
    # mode on seeded N(0, 1) features (16 x 300 frames)
    python -m wekws_tpu_torch.tools.scale_det inits --seeds 666,667,668

``run`` copies the recipe into DIR (stage 1 rewrites its
``data/global_cmvn``) and writes ``score_<seed>.txt.gz``, the
recipe's own step-0.01 ``stats_<seed>.txt`` and ``test.list.gz`` into
--out.  ``report`` sweeps with the port's ``eval.compute_det`` and
``frr_at_fa_per_hour`` (the JAX package's code, copied) and lists the
false alarms: at the sweep's threshold for 1.0 FA/h, every filler
frame that triggers (the refractory skip of ``window_shift`` frames
included), and the highest peaks of the filler utterances (the 30
highest of those above 0.9).  ``inits`` tells a seed whose initial
posteriors sit near 1 from the start: at bf16 its sigmoid rounds to 1.0,
the max-pooling loss's clamp zeroes every gradient and it never trains.
"""

import argparse
import glob
import gzip
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, "examples", "synthetic_scale")
CONFIG = "conf_torch/mdtc.yaml"
KEYWORD = "0"


def _gzip(src, dst):
    with open(src, "rb") as fin, gzip.open(dst, "wb") as fout:
        shutil.copyfileobj(fin, fout)


def run(work, seeds, out):
    """The corpus and CMVN (stages 0-1) once, then stages 2-3 for every
    seed side by side; returns 0 if every stage exited 0."""
    os.makedirs(out, exist_ok=True)
    recipe = os.path.join(work, "synthetic_scale")
    shutil.copytree(RECIPE, recipe, ignore=shutil.ignore_patterns("exp"))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    subprocess.run(["bash", "run_torch.sh", "0", "1", CONFIG], cwd=recipe,
                   env=env, check=True)
    print(f"scale_det: stages 0-1 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    procs = {}
    for seed in seeds:
        log = open(os.path.join(out, f"log_{seed}.txt"), "w")
        procs[seed] = (subprocess.Popen(
            ["bash", "run_torch.sh", "2", "3", CONFIG], cwd=recipe,
            env=dict(env, TRAIN_SEED=str(seed)), stdout=log,
            stderr=subprocess.STDOUT), log)
    rc = 0
    for seed, (proc, log) in procs.items():
        proc.wait()
        log.close()
        print(f"scale_det: seed {seed} stages 2-3 exited {proc.returncode} "
              f"after {time.perf_counter() - t0:.1f} s", flush=True)
        rc = rc or proc.returncode
        exp = os.path.join(recipe, "exp",
                           f"torch_{os.path.basename(CONFIG)[:-5]}_seed{seed}")
        with open(os.path.join(out, f"log_{seed}.txt")) as f:
            for line in f:
                if "FRR at FA" in line or "stage" in line or "cv_loss" in line:
                    print(f"  seed {seed}: {line.rstrip()}")
        if proc.returncode == 0:
            _gzip(os.path.join(exp, "score.txt"),
                  os.path.join(out, f"score_{seed}.txt.gz"))
            shutil.copy(os.path.join(exp, "stats.0.txt"),
                        os.path.join(out, f"stats_{seed}.txt"))
    _gzip(os.path.join(recipe, "data", "test.list"),
          os.path.join(out, "test.list.gz"))
    return rc


def triggers(scores, threshold, window_shift):
    """The frames of one utterance that ``compute_det`` counts as alarms
    at ``threshold``: (frame, score), with its refractory skip."""
    out, i = [], 0
    while i < len(scores):
        if scores[i] >= threshold:
            out.append((i, scores[i]))
            i += window_shift
        else:
            i += 1
    return out


def report(out, step, window_shift=50):
    from wekws_tpu_torch.eval import (
        compute_det,
        frr_at_fa_per_hour,
        load_label_and_score,
    )

    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "test.list")
        with gzip.open(os.path.join(out, "test.list.gz"), "rb") as fin, \
                open(labels, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        for path in sorted(glob.glob(os.path.join(out, "score_*.txt.gz"))):
            seed = os.path.basename(path)[len("score_"):-len(".txt.gz")]
            scores = os.path.join(tmp, "score.txt")
            with gzip.open(path, "rb") as fin, open(scores, "wb") as fout:
                shutil.copyfileobj(fin, fout)
            keyword, filler, duration = load_label_and_score(
                KEYWORD, labels, scores)
            rows = compute_det(keyword, filler, duration, step=step,
                               window_shift=window_shift)
            hours = duration / 3600.0
            at = {fa: frr_at_fa_per_hour(rows, fa) for fa in (1.0, 0.1)}
            last = rows[-1]
            print(f"seed {seed}: {len(keyword)} keyword and {len(filler)} "
                  f"filler utterances, {hours:.4f} filler hours; step "
                  f"{step}: FRR {at[1.0]:.4f} at 1.0 FA/h, {at[0.1]:.4f} at "
                  f"0.1 FA/h; the sweep's last point: threshold {last[0]:.4f}"
                  f", {last[1]:.4f} FA/h, FRR {last[2]:.4f}")
            for fa in (1.0, 0.1):
                ok = [r for r in rows if r[1] <= fa]
                if ok:
                    best = min(ok, key=lambda r: (r[2], r[0]))
                    print(f"  {fa} FA/h: first reached at threshold "
                          f"{ok[0][0]:.4f} ({ok[0][1]:.4f} FA/h, FRR "
                          f"{ok[0][2]:.4f}); least FRR at threshold "
                          f"{best[0]:.4f}")
                else:
                    print(f"  {fa} FA/h: no sweep point")
            one = [r for r in rows if r[1] <= 1.0]
            if one:
                th = one[0][0]
                alarms = sorted(
                    ((s, key, i) for key, sc in filler.items()
                     for i, s in triggers(sc, th, window_shift)),
                    reverse=True)
                print(f"  the {len(alarms)} false alarms at threshold "
                      f"{th:.4f}: " + ", ".join(
                          f"{s:.6f} ({key} frame {i})"
                          for s, key, i in alarms))
            peaks = sorted(((max(sc), key) for key, sc in filler.items()
                            if sc and max(sc) > 0.9), reverse=True)
            print(f"  filler peaks above 0.9: {len(peaks)}, the highest "
                  + ", ".join(f"{s:.6f} ({key})" for s, key in peaks[:30]))
            kmax = sorted(max(sc) if sc else 0.0 for sc in keyword.values())
            print(f"  keyword peaks: least {kmax[0]:.6f}, below 0.99: "
                  f"{sum(s < 0.99 for s in kmax)}, below 0.999: "
                  f"{sum(s < 0.999 for s in kmax)}", flush=True)
    return 0


def inits(seeds):
    """Each seed's initial recipe model (``bin.train``'s draw), its
    mean posterior on the same seeded N(0, 1) features, on the CPU."""
    import torch
    import yaml

    from wekws_tpu_torch.models import init_model

    with open(os.path.join(RECIPE, CONFIG)) as f:
        conf = dict(yaml.safe_load(f)["model"], input_dim=40, output_dim=1)
    x = torch.randn((16, 300, 40), generator=torch.Generator().manual_seed(0))
    for seed in seeds:
        model = init_model(conf, torch.Generator().manual_seed(seed)).train()
        with torch.no_grad():
            post = model(x)[0].float()
        print(f"seed {seed}: initial mean posterior {float(post.mean()):.4f},"
              f" share at 1.0 {float((post == 1.0).float().mean()):.4f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--work", required=True)
    r.add_argument("--seeds", default="666,667")
    r.add_argument("--out", required=True)
    p = sub.add_parser("report")
    p.add_argument("--out", required=True)
    p.add_argument("--step", type=float, default=0.001)
    i = sub.add_parser("inits")
    i.add_argument("--seeds", default="666,667,668")
    args = ap.parse_args(argv)
    if args.cmd == "inits":
        return inits([int(s) for s in args.seeds.split(",")])
    if args.cmd == "run":
        return run(args.work, [int(s) for s in args.seeds.split(",")],
                   args.out)
    return report(args.out, args.step)


if __name__ == "__main__":
    sys.exit(main())
