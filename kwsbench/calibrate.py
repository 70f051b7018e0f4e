"""The readings that a cell's limits are set from, on the card.

    python3 kwsbench/calibrate.py --workload <name> --seeds <n> ... \
        [--mode program|control|half] [--seconds <s>] [--out <file>]

- ``program``: whole runs of the cell (set-up, a window of ``--seconds``,
  the check) in one process, one a seed: the lower readings.
- ``control``: the reference put in the program's place, computed in
  the precision below the configuration's (``precision``'s
  ``train_control``: TF32 for float32 products), at the cell's sizes,
  against the reference: the upper readings.
- ``half``: the reference with the second half of each
  batch left out, the mean taken over the rest, against the whole
  batch: a fault's readings.

Each seed prints one JSON line of its numbers (and appends it to
``--out``).  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_train(cell, half: bool) -> dict:
    import torch

    from kwsbench import correct
    from kwsbench.drivers import common, train_resident as tr_driver
    from kwsbench.reference import frontend as ref_frontend

    config = cell.config
    dc = config["dataset_conf"]
    feats = ref_frontend.Features(dc, cell.device)
    conf = common.model_conf(config, feats.dim)
    arrays = tr_driver.corpus_arrays(cell)
    idx = tr_driver.index_rows(cell, cell.traffic["check_steps"])
    batches = tr_driver.reference_batches(arrays, idx, len(idx))
    del arrays
    weights = common.port_model(conf, cell.seed, cell.device)[1]
    ref = tr_driver.reference_steps(cell, conf, weights, batches, "fp32")
    low = config["precision"]["train_control"]
    other = tr_driver.reference_steps(cell, conf, weights, batches,
                                      "fp32" if half else low, half=half)
    torch.cuda.empty_cache() if cell.device.type == "cuda" else None
    numbers, info = correct.train_numbers(other, ref)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=("program", "control", "half"),
                   default="program")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from kwsbench import harness

    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.make_cell(args.workload, seed, args.seconds, False, t0)
        if args.mode == "program":
            out = harness.run(cell)
            rec = {"numbers": cell.numbers, "correct": out["correct"],
                   "metrics": out["metrics"], "info": cell.info}
        else:
            cell.device = torch.device("cuda", 0)
            rec = {"numbers": control_train(cell, args.mode == "half")}
        rec.update(workload=args.workload, seed=seed, mode=args.mode,
                   seconds=time.perf_counter() - t0,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
