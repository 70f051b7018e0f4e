"""Port export and int8 (wekws_tpu_torch/export, bin/export_model,
bin/static_quantize, the torch migration tools) against the JAX package
on the CPU: the same artifacts byte for byte from the same weights, the
same quantized files and calibration, and the port's device runtime
(``TorchGraphRuntime``, run here on the CPU) against the numpy and JAX
runtimes on the same artifacts."""

import copy
import filecmp
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from test_cpp_runtime import LIB as CAPI_LIB
from test_cpp_runtime import capi  # noqa: F401  (the fixture)
from test_cpp_runtime import run_capi
from test_export import CONFIGS, export_setup
from wekws_tpu.export import GraphRuntime as JaxNpRuntime
from wekws_tpu.export.calibrate import (
    calibrate_activation_ranges as jax_calibrate,
)
from wekws_tpu.export.calibrate import feats_from_waves as jax_feats
from wekws_tpu.export.jax_runtime import JaxGraphRuntime
from wekws_tpu.export.quantize import quantize_artifact as jax_quantize
from wekws_tpu.tools.export_torch import export_torch_file as jax_to_torch
from wekws_tpu_torch.bin import export_model as export_cli
from wekws_tpu_torch.bin import export_torch as export_torch_cli
from wekws_tpu_torch.bin import import_torch as import_torch_cli
from wekws_tpu_torch.bin import static_quantize as quantize_cli
from wekws_tpu_torch.data.audio import read_wav, write_wav
from wekws_tpu_torch.export import (
    GraphRuntime,
    TorchGraphRuntime,
    export_model,
    quantize_artifact,
)
from wekws_tpu_torch.export.cached_step import load_cached_step
from wekws_tpu_torch.export.calibrate import (
    calibrate_activation_ranges,
    feats_from_waves,
)
from wekws_tpu_torch.export.torch_runtime import EXACT_K
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.models.kws_model import inference_model_conf
from wekws_tpu_torch.tools.export_torch import load_port_model
from wekws_tpu_torch.tools.from_jax import model_from_jax
from wekws_tpu_torch.tools.import_torch import import_torch_file
from wekws_tpu_torch.train.checkpoint import load_model_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the committed JAX fixtures: (experiment dir, recipe dir)
FIXTURES = {
    "ds_tcn": ("examples/synthetic/exp/ds_tcn", "examples/synthetic"),
    "fsmn_ctc": ("examples/synthetic_ctc/exp/fsmn_ctc",
                 "examples/synthetic_ctc"),
}
CTC_EXPORT = os.path.join(REPO, FIXTURES["fsmn_ctc"][0], "export")
CTC_INT8 = os.path.join(REPO, FIXTURES["fsmn_ctc"][0], "export_int8")
ARTIFACT_FILES = ("model.json", "model.txt", "weights.bin")


def _render():
    """``render`` of the synthetic CTC corpus generator (tone sequences
    over a noise floor), loaded from its file."""
    path = os.path.join(REPO, "examples", "synthetic_ctc", "local",
                        "gen_data_torch.py")
    spec = importlib.util.spec_from_file_location("gen_data_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render


def ctc_waves(seed, seqs=("41234213", "2134312", "12341243")):
    """int16-scale waves of the CTC corpus's kind, one per sequence."""
    render, rng = _render(), np.random.default_rng(seed)
    return [render(rng, s) * 32768.0 for s in seqs]


def fixture_model(name):
    """(configs as committed, the port model of the fixture's avg_5.ckpt
    with the CMVN file found in this checkout)."""
    fx, recipe = (os.path.join(REPO, p) for p in FIXTURES[name])
    with open(os.path.join(fx, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    conf = inference_model_conf(copy.deepcopy(configs["model"]))
    conf["cmvn"]["cmvn_file"] = os.path.join(recipe, "data", "global_cmvn")
    model = init_model(conf)
    model.load_state_dict(load_model_state(os.path.join(fx, "avg_5.ckpt"),
                                           conf, model))
    return configs, conf, model


def port_of(variables, conf):
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray,
                                   dict(variables.get("batch_stats", {})))
    return model_from_jax(params, stats, conf)


def same_files(a, b, names=ARTIFACT_FILES):
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def ctc_feats(n_frames=48):
    """(3, n_frames, 200) features of three CTC utterances through the
    fixture's frontend (fbank 40, context 2/2, skip 3)."""
    feats = feats_from_waves(CTC_EXPORT, ctc_waves(3))
    assert min(len(f) for f in feats) >= n_frames
    return np.stack([f[:n_frames] for f in feats])


# ---------------------------------------------------------------- export


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_equals_jax(name, tmp_path):
    """The JAX model (BN statistics perturbed) carried to the port
    through tools/from_jax exports to the JAX artifact: model.json equal
    as objects, model.txt and weights.bin byte for byte (both fold BN in
    float64); and the port's artifact matches the port model's forward
    at test_export.py's 2e-4 abs + 1e-3 rel."""
    _, variables, x, jax_dir = export_setup(name, tmp_path)
    model = port_of(variables, CONFIGS[name])
    out = str(tmp_path / "port")
    artifact = export_model(model, {"model": CONFIGS[name],
                                    "dataset_conf": {}}, out)
    with open(os.path.join(jax_dir, "model.json")) as f:
        assert artifact == json.load(f)
    same_files(out, jax_dir)
    with torch.inference_mode():
        want, _ = model(torch.from_numpy(np.array(x)))
    got, _ = GraphRuntime(out).forward(x[0])
    want = want.numpy()
    np.testing.assert_allclose(got[None] if want.ndim == 3 else got, want,
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_export_equals_committed(name, tmp_path):
    """The port's export of a committed JAX fixture's avg_5.ckpt, with
    its config.yaml, is the committed export/ directory file for
    file."""
    configs, _, model = fixture_model(name)
    export_model(model, configs, str(tmp_path))
    same_files(str(tmp_path), os.path.join(REPO, FIXTURES[name][0],
                                           "export"))


def test_export_model_cli(tmp_path):
    """``bin.export_model`` on the DS-TCN fixture's .ckpt and on a port
    .pt of the same weights: the committed weights.bin and model.txt,
    both gates passed; ``--format stablehlo`` writes a ``model.pt2``
    that loads and steps (tests/test_torch_exported_step.py holds it
    against JAX's)."""
    fx, recipe = (os.path.join(REPO, p) for p in FIXTURES["ds_tcn"])
    configs, conf, model = fixture_model("ds_tcn")
    configs["model"]["cmvn"] = conf["cmvn"]
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump(configs))
    pt = tmp_path / "avg_5.pt"
    torch.save(model.state_dict(), pt)
    for ckpt, out in ((os.path.join(fx, "avg_5.ckpt"), "from_ckpt"),
                      (str(pt), "from_pt")):
        err, dev_err = export_cli.main([
            "--config", str(config), "--checkpoint", ckpt, "--output_dir",
            str(tmp_path / out), "--device", "cpu"])
        assert err < 1e-3 and dev_err < 1e-3
        same_files(str(tmp_path / out), os.path.join(fx, "export"),
                   ("model.txt", "weights.bin"))
    err = export_cli.main(["--config", str(config), "--checkpoint", str(pt),
                           "--output_dir", str(tmp_path / "x"), "--format",
                           "stablehlo", "--device", "cpu"])
    assert err < 1e-5
    step = load_cached_step(str(tmp_path / "x" / "model.pt2"), "cpu")
    cache = model.init_cache(1)
    y, new_cache = step(torch.zeros((1, 32, conf["input_dim"])), cache)
    assert y.shape == (1, 32, 1) and torch.isfinite(y).all()
    assert [c.shape for c in new_cache] == [c.shape for c in cache]


# ------------------------------------------------------- quantize, calibrate


@pytest.mark.parametrize("name,static", [
    ("ds_tcn_sigmoid", True), ("fsmn_ctc", True), ("mdtc_ctc", False)])
def test_quantize_equals_jax(name, static, tmp_path):
    """``quantize_artifact`` (static with seeded calibration features,
    or weights only) writes JAX's three files byte for byte from the
    same artifact, and ``calibrate_activation_ranges`` gives JAX's
    qparams."""
    _, _, _, art = export_setup(name, tmp_path)
    calib = None
    if static:
        rng = np.random.default_rng(0)
        calib = [rng.standard_normal((50, CONFIGS[name]["input_dim"]))
                 .astype(np.float32) for _ in range(8)]
        assert calibrate_activation_ranges(art, calib) == jax_calibrate(
            art, calib)
    got = quantize_artifact(art, str(tmp_path / "port"), calib_feats=calib)
    want = jax_quantize(art, str(tmp_path / "jax"), calib_feats=calib)
    assert got == want and got["meta"]["static_quant"] is static
    same_files(str(tmp_path / "port"), str(tmp_path / "jax"),
               ARTIFACT_FILES + ("weights_int8.bin",))


def test_feats_from_waves_match_jax():
    """The calibration features of the fixture's fbank frontend (context
    2/2, skip 3) through the port's StreamingFrontend against the JAX
    package's: the same frames within 1e-3 abs (float32 log-mel with
    another summation order; ROADMAP C.16 is the MFCC departure)."""
    waves = ctc_waves(1)
    got, want = feats_from_waves(CTC_EXPORT, waves), jax_feats(CTC_EXPORT,
                                                               waves)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_static_quantize_cli(tmp_path):
    """``bin.static_quantize --calib_data`` on a list of rendered CTC
    utterances: the files of ``quantize_artifact`` on the same
    features, and the deviation it reports, the float against the int8
    artifact on those features, that of the numpy runtimes within 2e-5
    (the runtimes' pin) + 1e-6 rel."""
    lines = []
    for i, wave in enumerate(ctc_waves(2)):
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, wave / 32768.0, 16000)
        lines.append(json.dumps({"key": f"u{i}", "wav": path}))
    data = tmp_path / "calib.list"
    data.write_text("\n".join(lines) + "\n")
    err = quantize_cli.main(["--model_dir", CTC_EXPORT, "--output_dir",
                             str(tmp_path / "cli"), "--calib_data",
                             str(data), "--device", "cpu"])
    feats = feats_from_waves(CTC_EXPORT, [
        read_wav(json.loads(x)["wav"])[0] * 32768.0 for x in lines])
    quantize_artifact(CTC_EXPORT, str(tmp_path / "lib"), calib_feats=feats)
    same_files(str(tmp_path / "cli"), str(tmp_path / "lib"),
               ARTIFACT_FILES + ("weights_int8.bin",))
    f32, q = GraphRuntime(CTC_EXPORT), GraphRuntime(str(tmp_path / "lib"))
    want = max(float(np.abs(f32.forward(x)[0] - q.forward(x)[0]).max())
               for x in feats)
    assert want > 0.0
    assert err == pytest.approx(want, abs=2e-5, rel=1e-6)


# ------------------------------------------------------------ the runtime


@pytest.mark.parametrize("art", [CTC_EXPORT, CTC_INT8], ids=["float",
                                                              "int8"])
def test_runtime_matches_jax_runtimes(art):
    """``TorchGraphRuntime`` (CPU) on the committed float and static-int8
    CTC fixtures, three rows at once, against JAX's numpy
    ``GraphRuntime`` row by row and its batched ``JaxGraphRuntime``:
    2e-5 abs (tests/test_jax_runtime.py's pin, set on outputs of order
    1) + 1e-6 rel (this fixture's logits reach 15, where a float32 ulp
    is 9.5e-7 and the float products sum in another order)."""
    x = ctc_feats()
    got, _ = TorchGraphRuntime(art, "cpu").forward(x)
    got = got.numpy()
    for b in range(len(x)):
        want, _ = JaxNpRuntime(art).forward(x[b])
        np.testing.assert_allclose(got[b], want, atol=2e-5, rtol=1e-6)
    want, _ = JaxGraphRuntime(art).forward(x)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("art", [CTC_EXPORT, CTC_INT8], ids=["float",
                                                              "int8"])
def test_runtime_rows_and_chunks(art):
    """One batched call equals each row alone, and chunks of 7 frames
    with the carried state equal one full call: 1e-6 abs."""
    rt = TorchGraphRuntime(art, "cpu")
    x = ctc_feats()
    full, _ = rt.forward(x)
    for b in range(len(x)):
        row, _ = rt.forward(x[b])
        np.testing.assert_allclose(full[b].numpy(), row.numpy(), atol=1e-6,
                                   rtol=0)
    state, outs = rt.init_state(len(x)), []
    for s in range(0, x.shape[1], 7):
        y, state = rt.forward(x[:, s:s + 7], state)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-6, rtol=0)


def test_int8_accumulators_equal_numpy():
    """Every int8 op's int32 accumulator (zero point folded) on the
    committed static-int8 fixture equals the numpy runtime's shifted
    int32 accumulator, 0 apart, row by row."""
    x = ctc_feats()
    got, want = {}, {}
    TorchGraphRuntime(CTC_INT8, "cpu").forward(
        x, acc_observer=lambda i, k, a: got.__setitem__((i, k), a))
    rt = GraphRuntime(CTC_INT8)
    for b in range(len(x)):
        rt.forward(x[b], acc_observer=lambda i, k, a, b=b:
                   want.__setitem__((b, i, k), a))
    assert len(got) == 16 and len(want) == 3 * len(got)
    for (b, i, k), acc in want.items():
        assert got[i, k].dtype == torch.int32
        np.testing.assert_array_equal(got[i, k][b].numpy(), acc)


def _wide_dense(tmp_path, k):
    """A one-op static-int8 artifact: dense of K=``k`` inputs to 3, the
    weights at the int8 range's end, zero point 0."""
    out = tmp_path / f"k{k}"
    out.mkdir()
    q = np.full((k, 3), -127, np.int8)
    q[:, 1] = 127
    q[::2, 2] = 113
    scale = np.full(3, 0.5, np.float32)
    artifact = {
        "meta": {"format_version": 1, "output": 1, "output_dim": 3,
                 "cache_len": 0, "cache_dim": 0, "activation": "identity",
                 "dataset_conf": {}, "model_conf": {"input_dim": k},
                 "quantized": True, "static_quant": True},
        "ops": [{"op": "dense", "inputs": [0], "out": 1,
                 "attrs": {"act": "none", "in_scale": 1.0, "in_zp": 0},
                 "W": {"int8": {"offset": 0, "shape": [k, 3]},
                       "scale": {"offset": 0, "shape": [3]}}}],
        "caches": []}
    (out / "model.json").write_text(json.dumps(artifact))
    scale.astype("<f4").tofile(out / "weights.bin")
    q.tofile(out / "weights_int8.bin")
    return str(out), q


def test_int8_exact_range(tmp_path):
    """At K = 1,032 (the widest exact float32 contraction of int8
    operands) the accumulators of inputs at -128 and 127 equal numpy's
    int32 and int64 sums; an int8 op of K = 1,033 raises at
    construction."""
    assert EXACT_K == 1032
    art, q = _wide_dense(tmp_path, EXACT_K)
    x = np.full((2, 4, EXACT_K), -300.0, np.float32)  # clamps to -128
    x[1, :, ::3] = 127.0
    got, want = {}, {}
    TorchGraphRuntime(art, "cpu").forward(
        x, acc_observer=lambda i, k, a: got.__setitem__(k, a))
    for b in range(2):
        GraphRuntime(art).forward(
            x[b], acc_observer=lambda i, k, a, b=b: want.__setitem__(b, a))
        exact = np.clip(x[b], -128, 127).astype(np.int64) @ q.astype(
            np.int64)
        np.testing.assert_array_equal(got["W"][b].numpy(), want[b])
        np.testing.assert_array_equal(want[b], exact)
    assert int(np.abs(want[0]).max()) == 128 * 127 * EXACT_K
    art, _ = _wide_dense(tmp_path, EXACT_K + 1)
    with pytest.raises(ValueError, match="K=1033 exceeds 1032"):
        TorchGraphRuntime(art, "cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_runtime_matches_numpy_on_configs(name, tmp_path):
    """Each test_export.py configuration exported by the port: the device
    runtime against the numpy runtime (2e-5 abs), and chunks of 7 with
    the carried state against one call (1e-5, test_export.py's)."""
    _, variables, x, _ = export_setup(name, tmp_path, seed=3)
    out = str(tmp_path / "port")
    export_model(port_of(variables, CONFIGS[name]),
                 {"model": CONFIGS[name], "dataset_conf": {}}, out)
    rt = TorchGraphRuntime(out, "cpu")
    got, _ = rt.forward(x)
    want, _ = GraphRuntime(out).forward(x[0])
    np.testing.assert_allclose(got[0].numpy(), want, atol=2e-5, rtol=0)
    if name == "mdtc_global_ce":
        return  # a pooled head does not stream
    state, outs = rt.init_state(1), []
    for s in range(0, x.shape[1], 7):
        y, state = rt.forward(x[:, s:s + 7], state)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), got.numpy(),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["ds_tcn_sigmoid", "fsmn_ctc", "mdtc_ctc",
                                  "tcn_sigmoid"])
def test_static_int8_runtime_matches_numpy(name, tmp_path):
    """Static int8 from seeded calibration features: the device runtime
    against the numpy runtime (outputs 2e-5, every int8 accumulator
    equal), dw_conv, conv and fsmn_block taps among the int8 ops."""
    _, _, x, art = export_setup(name, tmp_path)
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal((50, CONFIGS[name]["input_dim"]))
             .astype(np.float32) for _ in range(8)]
    qdir = str(tmp_path / "q")
    quantize_artifact(art, qdir, calib_feats=calib)
    got_acc, want_acc = {}, {}
    got, _ = TorchGraphRuntime(qdir, "cpu").forward(
        x, acc_observer=lambda i, k, a: got_acc.__setitem__((i, k), a))
    want, _ = GraphRuntime(qdir).forward(
        x[0], acc_observer=lambda i, k, a: want_acc.__setitem__((i, k), a))
    np.testing.assert_allclose(got[0].numpy(), want, atol=2e-5, rtol=0)
    assert got_acc.keys() == want_acc.keys() and got_acc
    for key, acc in want_acc.items():
        np.testing.assert_array_equal(got_acc[key][0].numpy(), acc)


# -------------------------------------------------- export_torch, import_torch


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_export_torch_equals_jax(name, tmp_path):
    """``bin.export_torch`` of a fixture's .ckpt writes JAX's
    ``export_torch_file``'s state_dict (keys, layouts, dtypes, the
    one-element ``num_batches_tracked``, no CMVN buffers for a
    ``cmvn_file``); ``bin.import_torch`` of it gives back the port
    state, 0 apart, and of JAX's file the same."""
    fx = os.path.join(REPO, FIXTURES[name][0])
    configs, conf, _ = fixture_model(name)
    configs["model"]["cmvn"] = conf["cmvn"]
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump(configs))
    ckpt = os.path.join(fx, "avg_5.ckpt")
    got_pt, want_pt = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    export_torch_cli.main(["--checkpoint", ckpt, "--config", str(config),
                           "--output", got_pt, "--device", "cpu"])
    jax_to_torch(ckpt, configs["model"], want_pt)
    got, want = torch.load(got_pt), torch.load(want_pt)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    state = load_port_model(ckpt, configs["model"], "cpu").state_dict()
    for pt in (got_pt, want_pt):
        out = str(tmp_path / "imported.pt")
        import_torch_cli.main(["--torch_checkpoint", pt, "--config",
                               str(config), "--output_checkpoint", out,
                               "--device", "cpu"])
        back = torch.load(out)
        assert back.keys() == state.keys()
        assert all(torch.equal(back[k], state[k]) for k in state)
        assert not os.path.exists(out + ".cmvn.json")


def test_import_torch_cmvn_and_strict(tmp_path):
    """A reference file that carries GlobalCMVN buffers (inline CMVN):
    ``<output>.cmvn.json`` holds them and the port model takes them; a
    file with a missing or extra tensor does not load."""
    conf = dict(CONFIGS["ds_tcn_sigmoid"],
                cmvn={"mean": [0.5] * 40, "istd": [2.0] * 40})
    model = init_model(conf, torch.Generator().manual_seed(3))
    pt = str(tmp_path / "m.pt")
    state = model.state_dict()
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               state.items()}}, pt)
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump({"model": conf}))
    out = str(tmp_path / "imported.pt")
    import_torch_cli.main(["--torch_checkpoint", pt, "--config",
                           str(config), "--output_checkpoint", out,
                           "--device", "cpu"])
    with open(out + ".cmvn.json") as f:
        cmvn = json.load(f)
    assert cmvn == {"mean": [0.5] * 40, "istd": [2.0] * 40}
    back = torch.load(out)
    assert all(torch.equal(back[k], v) for k, v in state.items())
    sd = dict(state)
    sd.pop("classifier.linear.bias")
    torch.save(sd, pt)
    with pytest.raises(RuntimeError, match="classifier.linear.bias"):
        import_torch_file(pt, conf, "cpu")


# ------------------------------------------------------------ C++ runtime


@pytest.fixture
def built_capi(request):
    """test_cpp_runtime.py's C API where the runtime is built; this
    file does not build it (two workers would build one directory)."""
    if not os.path.exists(CAPI_LIB):
        pytest.skip("the C++ runtime is not built here "
                    "(tests/test_cpp_runtime.py builds it)")
    return request.getfixturevalue("capi")


def test_cpp_runtime_runs_port_artifact(built_capi, tmp_path, rng):
    """The port's artifact of a small DS-TCN (context 2/2, skip 3)
    through the C++ runtime's C API (built as tests/test_cpp_runtime.py
    builds it; skipped where it cannot be) against the port model on the
    port's offline features: test_cpp_runtime.py's 2e-3 abs + 1e-3
    rel."""
    from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline

    dataset_conf = {
        "feats_type": "fbank",
        "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                       "frame_length": 25, "dither": 1.0},
        "context_expansion": True,
        "context_expansion_conf": {"left": 2, "right": 2},
        "frame_skip": 3,
    }
    conf = {"input_dim": 115, "output_dim": 3, "hidden_dim": 16,
            "preprocessing": {"type": "linear"},
            "backbone": {"type": "tcn", "ds": True, "num_layers": 2,
                         "kernel_size": 4, "dropout": 0.0}}
    model = init_model(conf, torch.Generator().manual_seed(1))
    out = str(tmp_path / "artifact")
    export_model(model, {"model": conf, "dataset_conf": dataset_conf}, out)
    wave = (rng.standard_normal(16000) * 1000).astype(np.float32)
    got, idx = run_capi(built_capi, out, wave)
    pipeline = DeviceFeaturePipeline.from_conf(dataset_conf, training=False)
    with torch.inference_mode():
        feats, flens = pipeline(torch.from_numpy(wave[None]),
                                torch.tensor([len(wave)]))
        want, _ = model(feats)
    want = want[0, :int(flens[0])].numpy()
    n = min(len(got), len(want))
    assert n > 20
    np.testing.assert_allclose(got[:n], want[:n], atol=2e-3, rtol=1e-3)
    np.testing.assert_array_equal(np.diff(idx), 3)
