"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points default to the GPU."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from wekws_tpu_torch.data.audio import write_wav
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.ops.serving import build_fused_forward, build_fused_stream
from wekws_tpu_torch.runtime import (
    BatchKeywordSpotter,
    BatchMaxPoolSpotter,
    KeyWordSpotter,
)
from wekws_tpu_torch.runtime.device_frontend import build_batch_featurizer
from wekws_tpu_torch.runtime.keyword_spotter import (
    load_serving_model,
    load_spotter_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import wekws_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    wekws_tpu_torch.__path__, "wekws_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "wekws_tpu_torch.data.device_aug" in names
assert {"wekws_tpu_torch.export." + m for m in (
    "graph", "np_runtime", "quantize", "calibrate", "torch_runtime")} \
    <= set(names)
assert {"wekws_tpu_torch.bin." + m for m in (
    "export_model", "static_quantize", "export_torch", "import_torch")} \
    <= set(names)
assert {"wekws_tpu_torch.parallel.mesh", "wekws_tpu_torch.parallel.launch"} \
    <= set(names)
assert {"wekws_tpu_torch.export.cached_step",
        "wekws_tpu_torch.bin.plot_det_curve"} <= set(names)
assert {"wekws_tpu_torch.tools." + m for m in (
    "bench_serving_slo", "drift_sweep", "gate_knobs")} <= set(names)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "wekws_tpu"))
# the plots' optional imports (ROADMAP C.29) happen only when one is drawn
optional = sorted(k for k in sys.modules
                  if k.split(".")[0] in ("matplotlib", "pypinyin"))
print(len(names), bad, optional)
assert not bad, bad
assert not optional, optional
"""

CONF = {
    "dataset_conf": {"feats_type": "fbank", "fbank_conf": {
        "num_mel_bins": 23, "frame_shift": 10, "frame_length": 25}},
    "model": {
        "input_dim": 23, "output_dim": 1, "hidden_dim": 32,
        "preprocessing": {"type": "linear"},
        "backbone": {"type": "mdtc", "num_stack": 1, "stack_size": 2,
                     "kernel_size": 5, "hidden_dim": 32, "causal": True},
    },
}


JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "wekws_tpu")
SCRIPTS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "examples", "*", "local", "*_torch.py"))
    + [os.path.join(REPO, "chip_smoke.py")])


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every module was imported, the serving daemon's (serving/,
    # bin/serve.py, runtime/device_frontend.py, decode/device_stream.py)
    # the resident corpus and host tools (data/resident.py,
    # tools/{cmvn_stats,make_blob,shuffle_list}.py) and the device
    # waveform augmentation (data/device_aug.py), export/ and its four
    # CLIs, export/cached_step.py and bin/plot_det_curve.py among them
    assert int(proc.stdout.split()[0]) >= 108


@pytest.mark.parametrize("entry", [
    "forward", "stream", "load", "engine", "spotter", "kws_engine",
    "featurizer", "artifact_load", "graph_runtime", "export_model",
    "static_quantize", "export_torch", "import_torch", "bench_serving_slo",
    "drift_sweep", "gate_knobs"])
def test_entry_points_default_to_cuda(tmp_path, monkeypatch, entry):
    """Called without ``device=`` they run on the GPU, or raise where
    there is none; they never fall back to the CPU."""
    from wekws_tpu_torch.bin import (
        export_model,
        export_torch,
        import_torch,
        static_quantize,
    )
    from wekws_tpu_torch.export import TorchGraphRuntime
    from wekws_tpu_torch.export import export_model as export_artifact
    from wekws_tpu_torch.tools import bench_serving_slo, drift_sweep
    from wekws_tpu_torch.tools import gate_knobs

    model = init_model(CONF["model"])
    ckpt = tmp_path / "m.pt"
    torch.save(model.state_dict(), ckpt)
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\n")
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump(CONF))
    art = str(tmp_path / "artifact")
    export_artifact(model, CONF, art)
    out = str(tmp_path / "out")
    # the tools' engines and training runs, stubbed: each records the
    # device that the tool resolved by default
    seen = []
    monkeypatch.setattr(bench_serving_slo, "bench_detection",
                        lambda args: seen.append(args.device))
    monkeypatch.setattr(drift_sweep, "run_engine",
                        lambda args, wavs, *_: seen.append(args.device)
                        or {i: [] for i in range(len(wavs))})
    monkeypatch.setattr(gate_knobs, "run_variant",
                        lambda name, out_root, device: seen.append(device)
                        or [1.0])
    wav = tmp_path / "a.wav"
    write_wav(str(wav), np.zeros(1600, np.float32), 16000)
    test_list = tmp_path / "test.list"
    test_list.write_text(json.dumps({"key": "a", "wav": str(wav)}) + "\n")

    def tool(main, argv):
        main(argv)
        return seen.pop().type == "cuda" or None

    calls = {
        "forward": lambda: build_fused_forward(model),
        "stream": lambda: build_fused_stream(model),
        "load": lambda: load_serving_model(CONF, str(ckpt), 23),
        "engine": lambda: BatchMaxPoolSpotter(str(ckpt), CONF, 0.5,
                                              num_streams=2),
        "spotter": lambda: KeyWordSpotter(str(ckpt), CONF, str(tokens), None,
                                          0.5),
        "kws_engine": lambda: BatchKeywordSpotter(str(ckpt), CONF,
                                                  str(tokens), None, 0.5,
                                                  num_streams=2),
        "featurizer": lambda: build_batch_featurizer(
            *load_spotter_config(CONF)[1:], step_frames=8),
        "artifact_load": lambda: load_serving_model(CONF, art, 23),
        "graph_runtime": lambda: TorchGraphRuntime(art),
        "export_model": lambda: export_model.main([
            "--config", str(config), "--checkpoint", str(ckpt),
            "--output_dir", out]),
        "static_quantize": lambda: static_quantize.main([
            "--model_dir", art, "--output_dir", out]),
        "export_torch": lambda: export_torch.main([
            "--checkpoint", str(ckpt), "--config", str(config), "--output",
            out]),
        "import_torch": lambda: import_torch.main([
            "--torch_checkpoint", str(ckpt), "--config", str(config),
            "--output_checkpoint", out]),
        "bench_serving_slo": lambda: tool(bench_serving_slo.main, [
            "--config", str(config), "--checkpoint", str(ckpt), "--tokens",
            str(tokens), "--keyword", "h", "--mode", "detection"]),
        "drift_sweep": lambda: tool(drift_sweep.main, [
            "--config", str(config), "--checkpoint", str(ckpt),
            "--token_file", str(tokens), "--keywords", "h", "--test_data",
            str(test_list)]),
        "gate_knobs": lambda: tool(gate_knobs.main, ["baseline"]),
    }
    if torch.cuda.is_available():
        assert calls[entry]() is not None
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            calls[entry]()


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_scripts_import_no_jax(script):
    """The port's scripts (the recipes' ``local/*_torch.py`` and
    ``chip_smoke.py``) name no JAX module and nothing of the JAX package
    in any import, at module level or inside a function."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read(), script)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names
    bad = sorted(n for n in names if n.split(".")[0] in JAX_ROOTS)
    assert not bad, bad


RUN_SCRIPTS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "examples", "*", "run*_torch.sh")))


@pytest.mark.parametrize("script", RUN_SCRIPTS)
def test_port_run_scripts_call_no_jax(script):
    """The recipes' port scripts (``run*_torch.sh``) call the port's
    modules and scripts only: no ``wekws_tpu.`` module (``-m`` or an
    import in a ``python -c``), no JAX, no JAX-package recipe script
    (``local/report.py``, ``local/gen_data.py``)."""
    with open(os.path.join(REPO, script), encoding="utf-8") as f:
        text = f.read()
    assert "wekws_tpu_torch" in text
    assert not re.search(r"wekws_tpu(?!_torch)\b", text), script
    assert not re.search(r"\b(import|from) (jax|flax|optax)\b", text)
    for name in re.findall(r"python3?\s+\S*local/(\w+)\.py", text):
        assert name.endswith("_torch") or name.startswith("prepare_"), name
