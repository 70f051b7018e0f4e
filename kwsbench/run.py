"""Run one cell of the benchmark once.

    python3 kwsbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  Prints the
result as the last line of standard output (one JSON object) and the
numbers that decide ``correct``, each beside its limit, as the last
lines of standard error.  Exits non-zero, printing no result, when the
cell's CUDA devices are missing or when JAX, flax or the JAX package
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _finite(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from kwsbench import correct, harness

    cell = harness.make_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), T0)
    out = harness.run(cell)
    banned = harness.banned_modules()
    if banned:
        print(f"kwsbench: modules loaded that the port must not load: "
              f"{', '.join(banned)}", file=sys.stderr)
        return 3
    for name, value in sorted(cell.numbers.items()):
        if name not in out["checks"]:
            print(f"reading {name} {value!r} (no limit)", file=sys.stderr)
    correct.print_checks(out["checks"])
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
