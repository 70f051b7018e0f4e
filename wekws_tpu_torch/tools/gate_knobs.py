"""Convergence gates for the training knobs: train the synthetic recipe
with a knob flipped and print its cv_loss epoch by epoch beside the
baseline's.

Port of tools/gate_knobs.py, with the same positional variants and the
same table, plus ``--device`` (``cuda`` by default, ``cpu`` for the
tests; ``cuda`` without a GPU raises).  Each variant trains
examples/synthetic's ``conf/ds_tcn.yaml``, changed by the variant,
through ``python -m wekws_tpu_torch.bin.train`` with the JAX tool's
arguments, and reads each epoch's cv_loss from the checkpoint
sidecars.

``frontend_default`` has no counterpart (ROADMAP C.37): it sets
``fbank_conf.precision``, which the port does not have (both of JAX's
settings give the same float32 products here), so the variant would
train the baseline again.  Asked for by name, it raises; it is not in
the default list.

The corpus is the recipe's committed waves: the train and dev lists
are written under the output root as ``run_torch.sh``'s stage 0 writes
them, and the committed ``data/global_cmvn`` is used as it is.

Usage: python -m wekws_tpu_torch.tools.gate_knobs [variant ...]
           [--device cuda|cpu]
Variants: baseline dither_wave ghost_bn8 bf16 bf16_bn
Writes under examples/synthetic/exp/torch_gates/.
"""

import argparse
import copy
import os
import subprocess
import sys

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, "examples", "synthetic")


def _dither_wave(c):
    c["dataset_conf"]["fbank_conf"]["dither_mode"] = "wave"
    return c


def _ghost_bn8(c):
    c["model"]["backbone"]["ghost_bn"] = 8
    return c


def _bf16(c):
    c["model"]["dtype"] = "bfloat16"
    return c


def _bf16_bn(c):
    c["model"]["dtype"] = "bfloat16"
    c["model"]["backbone"]["bn_dtype"] = "bfloat16"
    return c


VARIANTS = {
    "baseline": lambda c: c,
    "dither_wave": _dither_wave,
    "ghost_bn8": _ghost_bn8,
    "bf16": _bf16,
    "bf16_bn": _bf16_bn,
}
# the JAX tool's variants that set a key the port does not have
NO_COUNTERPART = {"frontend_default": "dataset_conf.fbank_conf.precision"}


def variant_conf(name, conf):
    """``conf`` (a recipe config dict, not changed) with variant
    ``name`` applied."""
    if name in NO_COUNTERPART:
        raise ValueError(
            f"variant {name!r} sets {NO_COUNTERPART[name]}, which the port "
            f"does not have (both of its settings give the same float32 "
            f"products): it would train the baseline again")
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; variants: "
                         f"{' '.join(VARIANTS)}")
    return VARIANTS[name](copy.deepcopy(conf))


def _merge(conf, overrides):
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(conf.get(k), dict):
            _merge(conf[k], v)
        else:
            conf[k] = v
    return conf


def make_lists(recipe, data):
    """``data``/{train,dev}.list from ``recipe``/data/{train,dev}/*.wav:
    key ``<split>_<i>``, label "0" (keyword) for even i and "-1"
    (filler) for odd i, as ``run_torch.sh``'s stage 0 writes them.
    Returns {split: list path}."""
    from wekws_tpu_torch.tools.durations import wav_durations
    from wekws_tpu_torch.tools.make_list import make_list

    os.makedirs(data, exist_ok=True)
    lists = {}
    for split in ("train", "dev"):
        wav_dir = os.path.abspath(os.path.join(recipe, "data", split))
        n = sum(name.endswith(".wav") for name in os.listdir(wav_dir))
        wavs = {f"{split}_{i}": os.path.join(wav_dir, f"{split}_{i}.wav")
                for i in range(n)}
        scp, text, dur = (os.path.join(data, f"{split}.{ext}")
                          for ext in ("scp", "text", "dur"))
        with open(scp, "w") as f:
            f.writelines(f"{k} {path}\n" for k, path in wavs.items())
        with open(text, "w") as f:
            f.writelines(f"{k} {0 if i % 2 == 0 else -1}\n"
                         for i, k in enumerate(wavs))
        wav_durations(wavs.items(), dur)
        lists[split] = os.path.join(data, f"{split}.list")
        make_list(scp, text, dur, lists[split])
    return lists


def run_variant(name, out_root, recipe=RECIPE, device="cuda",
                overrides=None):
    """Train variant ``name`` of ``recipe``'s conf/ds_tcn.yaml (deep-
    merged with ``overrides``) into ``out_root``/``name`` on
    ``device``; returns its cv losses, epoch by epoch."""
    with open(os.path.join(recipe, "conf", "ds_tcn.yaml")) as f:
        conf = yaml.safe_load(f)
    conf = _merge(variant_conf(name, conf), copy.deepcopy(overrides or {}))
    lists = make_lists(recipe, os.path.join(out_root, "data"))
    vdir = os.path.join(out_root, name)
    os.makedirs(vdir, exist_ok=True)
    cpath = os.path.join(vdir, "conf.yaml")
    with open(cpath, "w") as f:
        yaml.dump(conf, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(
        [sys.executable, "-m", "wekws_tpu_torch.bin.train",
         "--config", cpath,
         "--train_data", lists["train"],
         "--cv_data", lists["dev"],
         "--model_dir", vdir,
         "--num_keywords", "1", "--min_duration", "20",
         "--seed", "666",
         "--cmvn_file", os.path.join(recipe, "data", "global_cmvn"),
         "--norm_var",
         "--device", str(device)],
        check=True, env=env, cwd=REPO,
    )
    # cv_loss lives in the per-epoch checkpoint sidecars
    losses = []
    e = 0
    while os.path.exists(os.path.join(vdir, f"{e}.yaml")):
        with open(os.path.join(vdir, f"{e}.yaml")) as f:
            losses.append(float(yaml.safe_load(f)["cv_loss"]))
        e += 1
    return losses


def table_lines(results):
    """The gate's table: a header of the variants, then one row an
    epoch (nan where a variant has no such epoch)."""
    epochs = max(len(v) for v in results.values())
    lines = ["epoch " + " ".join(f"{n:>18s}" for n in results)]
    for e in range(epochs):
        row = f"{e:5d} "
        for n in results:
            v = results[n][e] if e < len(results[n]) else float("nan")
            row += f" {v:18.4f}"
        lines.append(row)
    return lines


def main(argv=None):
    from wekws_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"default: {' '.join(VARIANTS)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.variants or list(VARIANTS)
    for name in names:  # each name checked before the first run
        if name not in VARIANTS:
            variant_conf(name, {})
    out_root = os.path.join(RECIPE, "exp", "torch_gates")
    results = {}
    for name in names:
        print(f"=== {name} ===", flush=True)
        results[name] = run_variant(name, out_root, device=device)
    for line in table_lines(results):
        print(line)
    return results


if __name__ == "__main__":
    main()
