"""The port's initial model draw against the JAX package's, at the
configuration of ``examples/synthetic_scale`` (the flagship MDTC at
bf16 with ``bn_dtype``; ``conf/mdtc.yaml`` for JAX, ``conf_torch/mdtc.yaml``
for the port, as ``tools/scale_det.py`` builds them), on the CPU.

(a) Pooled over the same seeds, every tensor of the port's
``init_model`` has the mean and standard deviation of JAX's
``init_model``'s: the standard deviation within STD_TOL where the
pooled tensor holds at least MIN_VALUES values, the mean within
MEAN_SE standard errors of the difference of two means, and both
exactly equal where JAX's tensor is a constant (zero spread: the biases,
BatchNorm's scales and statistics).  The tensors are paired by
``tools/from_jax.py``'s mapping.

(b) JAX's initial parameters, carried over by ``from_jax``, give the
same initial posteriors in both packages in training mode on one seeded
N(0, 1) batch: within POST_TOL abs + POST_TOL rel element by element in
float32 (the two packages' own arithmetic, summed in other orders), and
the mean posterior within MEAN_POST_TOL at the recipe's bf16, where a
bf16 rounding that differs between the two (another summation order,
another rounding point) moves single posteriors on the sigmoid's steep
part by up to about 0.1 and a mean over 800 frames by about 1e-3; a
saturated draw and a trained-from draw lie some 0.9 apart.

Run with ``-s`` to print each seed's initial mean posterior in both
packages: a draw that starts saturated (a mean posterior near 1) is the
recipe's, in JAX's draws as in the port's."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.tools.from_jax import model_from_jax, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic_scale")
SEEDS = tuple(range(666, 674))
STD_TOL = 0.05
MIN_VALUES = 1024
MEAN_SE = 4.0
POST_TOL = 1e-5  # abs + rel: float32 sums over 17 blocks in other orders
MEAN_POST_TOL = 5e-3
BATCH = (8, 100, 40)


def _confs(float32=False):
    """(JAX's, the port's) model configs of the recipe; ``float32``
    drops ``dtype`` and ``bn_dtype`` from both."""
    out = []
    for path in ("conf/mdtc.yaml", "conf_torch/mdtc.yaml"):
        with open(os.path.join(RECIPE, path)) as f:
            conf = dict(yaml.safe_load(f)["model"], input_dim=40,
                        output_dim=1)
        if float32:
            conf = copy.deepcopy(conf)
            conf.pop("dtype")
            conf["backbone"].pop("bn_dtype")
        out.append(conf)
    return tuple(out)


@pytest.fixture(scope="module")
def jax_draws():
    """{seed: JAX's initial variables}, one jitted init for all seeds."""
    conf, _ = _confs()
    x = jnp.asarray(np.zeros(BATCH, np.float32))
    init = jax.jit(jax_init_model(conf).init)
    return {seed: jax.device_get(init(jax.random.PRNGKey(seed), x))
            for seed in SEEDS}


def test_initial_draw_matches_jax(jax_draws):
    """(a): each tensor's pooled mean and spread, JAX's draw vs the
    port's, over SEEDS."""
    conf, conf_t = _confs()
    pooled_j, pooled_t = {}, {}
    for seed in SEEDS:
        v = jax_draws[seed]
        sd = state_dict_from_jax(v["params"], v["batch_stats"], conf)
        st = init_model(conf_t, torch.Generator().manual_seed(seed))
        st = st.state_dict()
        assert set(sd) == set(st)
        for name, val in sd.items():
            pooled_j.setdefault(name, []).append(
                np.asarray(val, np.float64).ravel())
            pooled_t.setdefault(name, []).append(
                st[name].double().numpy().ravel())
    checked = 0
    for name in pooled_j:
        a = np.concatenate(pooled_j[name])
        b = np.concatenate(pooled_t[name])
        assert a.shape == b.shape, name
        if a.std() == 0.0:
            assert b.std() == 0.0 and a.mean() == b.mean(), name
            continue
        se = a.std() * np.sqrt(2.0 / a.size)
        assert abs(a.mean() - b.mean()) <= MEAN_SE * se, (
            name, a.mean(), b.mean(), se)
        if a.size >= MIN_VALUES:
            assert abs(b.std() / a.std() - 1.0) <= STD_TOL, (
                name, a.std(), b.std())
            checked += 1
    # the preprocessing linear and each of the 17 blocks' depthwise and
    # two pointwise kernels
    assert checked == 52


@pytest.mark.parametrize("float32", [True, False])
def test_initial_posteriors_match_jax(jax_draws, float32):
    """(b): JAX's initial parameters in both packages, training mode, one
    seeded N(0, 1) batch; the port runs its recipe's route (the fused
    passes' plain versions on the CPU)."""
    conf, conf_t = _confs(float32)
    model = jax_init_model(conf)
    x = np.random.default_rng(0).standard_normal(BATCH).astype(np.float32)

    @jax.jit
    def forward(variables):
        (out, _), _ = model.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        return out

    means = []
    for seed in SEEDS:
        v = jax_draws[seed]
        want = np.asarray(forward(v), np.float32)
        port = model_from_jax(v["params"], v["batch_stats"], conf_t).train()
        with torch.no_grad():
            got = port(torch.from_numpy(x))[0].float().numpy()
        assert got.shape == want.shape
        if float32:
            assert np.allclose(got, want, atol=POST_TOL, rtol=POST_TOL), (
                seed, np.abs(got - want).max())
        assert abs(got.mean() - want.mean()) <= MEAN_POST_TOL, seed
        means.append((seed, float(want.mean()), float(got.mean())))
    print("initial mean posterior (seed, JAX, port on JAX's weights), "
          + ("float32: " if float32 else "bf16: ")
          + ", ".join(f"{s} {a:.4f} {b:.4f}" for s, a, b in means))
