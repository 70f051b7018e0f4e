"""The JAX package's training knobs in the port (ROADMAP A.15) against
the JAX package on the CPU: ``dtype: bfloat16`` on the fused block (JAX's
Pallas kernels in interpret mode at ``precision="bfloat16"``, the port's
plain passes at the same precision) and on the module route of every
backbone, with and without ``bn_dtype``; ``remat``; ``GhostBatchNorm``
and ``ghost_bn`` on the model.  Inputs come from numpy seeds and the
weights cross over through ``tools/from_jax.py``.  The two-rank ghost-BN
case runs in tests/test_torch_parallel.py's spawn.

bf16 bounds.  The fused block is the kernels' own algorithm: the same
rounding points on both sides, so only the order of float32 sums and,
where that order moves a value across a bf16 rounding point, a bf16 tie
differ; no element lies near either ReLU's kink, where a tie would flip
a gate (bn1's bias is moved per channel off the inner kink, the
upstream gradient is zero near the residual one).  The module route
rounds where flax rounds, but its cuDNN-free taps, its reductions and
XLA's convolutions sum in other orders, so it is held at the JAX
package's own bf16 level (2e-2 of the output's scale in
tests/test_models.py), its weights' gradients to a quarter of JAX's
own bf16-vs-float32 difference (a port that computed in float32 would
sit at that whole difference) and every gradient to 3e-2 of the model's
largest: the gradient of a bias that a bf16 product precedes is a sum
of bf16 cotangents, which XLA on the CPU sums in bf16 and the port in
float32, so there the port sits closer to float32 than JAX does
(ROADMAP C.25)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.models.layers import GhostBatchNorm as JaxGhostBatchNorm
from wekws_tpu.ops.fused_mdtc_train import (
    fused_tcn_block_train as jax_fused_block,
)
from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.models import mdtc as port_mdtc
from wekws_tpu_torch.models.layers import BatchNorm, GhostBatchNorm
from wekws_tpu_torch.models.mdtc import TCNBlock
from wekws_tpu_torch.ops.fused_mdtc_train import (
    PARAM_KEYS,
    PASSES,
    _kernel_layout,
    _pw1,
    block_forward,
    fused_tcn_block_train,
    trace_pass_inputs,
)
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax
from wekws_tpu_torch.train import Trainer

C, K = 32, 3
# fused block at bf16 against JAX's interpret-mode kernels, as shares of
# each tensor's largest |value| (the gradients: of max(1, the largest
# |grad| of the twelve)); a bf16 tie moves an operand by 2^-8 of itself
FUSED_OUT_TOL = 4e-3  # y and dx
FUSED_STAT_TOL = 5e-4  # the six batch statistics
FUSED_GRAD_TOL = 2e-3
# module route at bf16 against JAX's modules
MODULE_OUT_TOL = 2e-2  # tests/test_models.py's bf16 bound
MODULE_GRAD_TOL = 3e-2  # of the model's largest |grad|
MODULE_GRAD_SHARE = 0.25  # weights: of JAX's own bf16-vs-float32 difference
# running statistics: the variance within 2e-2 of its largest, the mean
# within 2e-2 of the largest standard deviation (a mean near zero has
# no scale of its own)
MODULE_STAT_TOL = 2e-2


def _params(rng, c=C, k=K):
    def r(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"dw_kernel": r(k, 1, c), "dw_bias": r(c),
         "pw1_kernel": r(c, c, scale=c ** -0.5), "pw1_bias": r(c, scale=0.1),
         "pw2_kernel": r(c, c, scale=c ** -0.5), "pw2_bias": r(c, scale=0.1)}
    for i in range(3):
        p[f"bn{i}_scale"] = 1.0 + r(c, scale=0.1)
        p[f"bn{i}_bias"] = r(c, scale=0.1)
    return p


def _plain(name, *args):
    return PASSES[name].plain(*args)


def _gap_shift(s, width):
    """Per channel of ``s`` (B, T, C), the shift that moves zero to the
    middle of the widest gap between its values within ``width`` of
    zero (chip_smoke.py's ``kink_gap_shift``)."""
    out = []
    for col in s.reshape(-1, s.shape[-1]).T:
        z = np.sort(col[np.abs(col) < width])
        z = np.concatenate([[-width], z, [width]])
        i = int(np.argmax(z[1:] - z[:-1]))
        out.append(-(z[i] + z[i + 1]) / 2)
    return np.asarray(out, np.float32)


def _clear_of_kinks(p, x, cot, dilation, band=1e-2):
    """bn1's bias moved per channel so that no bn1 output lies within
    ``band`` / 2 of the inner ReLU's kink, and the upstream gradient
    zeroed where the residual ReLU's input lies within ``band`` of its
    kink (the port's plain bf16 forward)."""
    xt = torch.from_numpy(x)

    def forward(pp):
        kp = _kernel_layout({k: torch.from_numpy(v) for k, v in pp.items()})
        _, _, w, v = block_forward(xt, kp, dilation, 1e-5, _plain,
                                   "bfloat16")
        return kp, w, v

    kp, _, v = forward(p)
    _, _, vv = _pw1(xt, kp["dw_kernel"], kp["pw1_kernel"], v, dilation,
                    "bfloat16")
    p = dict(p, bn1_bias=p["bn1_bias"]
             + _gap_shift((vv * v["a1"] + v["c1"]).numpy(), 2 * band))
    _, w, v = forward(p)
    pre = (w * v["a2"] + v["c2"] + xt).numpy()
    return p, np.where(np.abs(pre) < band, 0.0, cot).astype(np.float32)


def _share(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("dilation", [1, 2])
def test_fused_block_bf16_matches_jax(dilation):
    """The fused block at ``precision="bfloat16"``, B=4 x T=40 x C=32:
    y, the six statistics and every gradient against JAX's
    ``fused_tcn_block_train(..., precision="bfloat16")`` in interpret
    mode, as shares of each tensor's scale (FUSED_*_TOL); y and every
    gradient float32, r bf16 between the passes.  At float32 the same
    inputs agree 100x closer, so the bf16 operands are what is held."""
    rng = np.random.default_rng(10 + dilation)
    p = _params(rng)
    x = rng.standard_normal((4, 40, C)).astype(np.float32)
    p, cot = _clear_of_kinks(p, x, rng.standard_normal(x.shape), dilation)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def jax_block(xx, pp):
        return jax_fused_block(xx, pp, K, dilation, 1e-5, 4, "bfloat16")

    y_j, stats_j = jax_block(jnp.asarray(x), jp)
    gx_j, gp_j = jax.grad(lambda xx, pp: jnp.sum(jax_block(xx, pp)[0] * cot),
                          argnums=(0, 1))(jnp.asarray(x), jp)

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, stats = fused_tcn_block_train(xt, leaves, K, dilation,
                                     precision="bfloat16")
    (y * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == xt.grad.dtype == torch.float32
    assert all(leaves[k].grad.dtype == torch.float32 for k in PARAM_KEYS)
    assert _share(y.detach(), y_j) <= FUSED_OUT_TOL
    assert _share(xt.grad, gx_j) <= FUSED_OUT_TOL
    for key in stats_j:
        assert _share(stats[key], stats_j[key]) <= FUSED_STAT_TOL, key
    scale = max([float(np.abs(np.asarray(gp_j[k])).max())
                 for k in PARAM_KEYS] + [1.0])
    for key in PARAM_KEYS:
        assert _share(leaves[key].grad, gp_j[key], scale) <= FUSED_GRAD_TOL, \
            key
    calls = trace_pass_inputs(torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(cot), dilation,
                              precision="bfloat16")
    assert calls["b2"][3].dtype == calls["b3"][3].dtype == torch.bfloat16
    assert calls["f2"][-1] == calls["b3"][-1] == "bfloat16"
    assert calls["f1"][-1] == dilation and calls["b4"][-2] == dilation


def _conf(kind, **knobs):
    base = {"input_dim": 20, "output_dim": 1, "hidden_dim": 32,
            "preprocessing": {"type": "linear"}}
    backbone = {
        "mdtc": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                 "kernel_size": 3, "hidden_dim": 32, "causal": True},
        "ds_tcn": {"type": "tcn", "ds": True, "num_layers": 3,
                   "kernel_size": 3, "dropout": 0.0},
        "tcn": {"type": "tcn", "ds": False, "num_layers": 3,
                "kernel_size": 3, "dropout": 0.0},
        "fsmn": {"type": "fsmn", "input_affine_dim": 24, "num_layers": 2,
                 "linear_dim": 32, "proj_dim": 16, "left_order": 4,
                 "right_order": 2, "left_stride": 1, "right_stride": 1,
                 "output_affine_dim": 24},
    }[kind]
    if kind == "fsmn":
        base.update(output_dim=7, preprocessing={"type": "none"},
                    classifier={"type": "identity", "dropout": 0.0},
                    activation={"type": "identity"})
    dtype = knobs.pop("dtype", None)
    if dtype:
        base["dtype"] = dtype
    return dict(base, backbone=dict(backbone, **knobs))


def _inputs(conf):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((4, 40, conf["input_dim"])).astype(
        np.float32)
    lengths = np.array([40, 33, 40, 21], np.int32)
    cot = rng.standard_normal((4, 40, conf["output_dim"])).astype(np.float32)
    return feats, lengths, cot


def _jax_step(conf, variables, feats, lengths, cot):
    """JAX's jitted training-mode outputs, updated batch statistics and
    loss gradients (its eager ones differ from them by far less than
    these tests' bounds, and take three times as long)."""
    model = jax_init_model(conf)
    stats = variables.get("batch_stats", {})

    def loss(pp):
        (out, _), upd = model.apply(
            {"params": pp, "batch_stats": stats}, jnp.asarray(feats),
            lengths=jnp.asarray(lengths), train=True,
            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd.get("batch_stats", {}))

    (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    return np.asarray(out), jax.device_get(new_stats), grads


def _port_step(conf, variables, feats, lengths, cot):
    stats = variables.get("batch_stats")
    model = model_from_jax(jax.device_get(variables["params"]),
                           jax.device_get(stats) if stats else None,
                           conf).train()
    out, _ = model(torch.from_numpy(feats), lengths=torch.from_numpy(lengths))
    (out * torch.from_numpy(cot)).sum().backward()
    return model, out


MODULE_CASES = [(kind, bn) for kind in ("mdtc", "ds_tcn", "tcn")
                for bn in (None, "bfloat16")] + [("fsmn", None)]


@pytest.mark.parametrize("kind,bn_dtype", MODULE_CASES)
def test_module_route_bf16_matches_jax(kind, bn_dtype):
    """``init_model`` at ``dtype: bfloat16`` (with and without
    ``bn_dtype``) for MDTC, DS-TCN, full-conv TCN and FSMN, unfused, in
    training mode on the same weights as JAX's eager modules: the output
    within MODULE_OUT_TOL of its largest |value|, every updated BN
    running statistic within MODULE_STAT_TOL, the loss gradients within
    MODULE_GRAD_TOL of the model's largest |grad|, the weights' within
    MODULE_GRAD_SHARE of JAX's own bf16-vs-float32 difference (JAX in
    float32 has neither knob); the output and every gradient float32."""
    knobs = {"bn_dtype": bn_dtype} if bn_dtype else {}
    conf = _conf(kind, dtype="bfloat16", **knobs)
    feats, lengths, cot = _inputs(conf)
    variables = jax_init_model(conf).init(
        jax.random.PRNGKey(0), jnp.asarray(feats),
        lengths=jnp.asarray(lengths))
    out_j, stats_j, grads_j = _jax_step(conf, variables, feats, lengths, cot)
    f32 = _conf(kind)
    _, _, grads_f32 = _jax_step(f32, variables, feats, lengths, cot)
    want = grads_from_jax(jax.device_get(grads_j), conf)
    want_f32 = grads_from_jax(jax.device_get(grads_f32), conf)

    model, out = _port_step(conf, variables, feats, lengths, cot)
    assert out.dtype == torch.float32
    assert _share(out.detach(), out_j) <= MODULE_OUT_TOL
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in named.values())
    scale = max(float(g.abs().max()) for g in want.values())
    errs = {k: float((named[k].grad - g).abs().max()) for k, g in want.items()}
    assert max(errs.values()) <= MODULE_GRAD_TOL * scale, (errs, scale)
    weights = [k for k in want if k.endswith("weight")]
    bf16_vs_f32 = max(float((want[k] - want_f32[k]).abs().max())
                      for k in weights)
    err = max(errs[k] for k in weights)
    assert err <= MODULE_GRAD_SHARE * bf16_vs_f32, (err, bf16_vs_f32)
    if stats_j:
        ref = dict(model_from_jax(jax.device_get(variables["params"]),
                                  stats_j, f32).named_buffers())
        bufs = dict(model.named_buffers())
        for name, buf in ref.items():
            if name.endswith("running_var"):
                assert _share(bufs[name], buf) <= MODULE_STAT_TOL, name
            elif name.endswith("running_mean"):
                std = float(ref[name[:-4] + "var"].sqrt().max())
                assert _share(bufs[name], buf, std) <= MODULE_STAT_TOL, name
            elif name.endswith("num_batches_tracked"):
                assert int(bufs[name]) == 1, name


def _remat_run(conf, state, feats, cot):
    model = init_model(conf)
    model.load_state_dict(state)
    model.train()
    out, _ = model(feats)
    loss = (out * cot).sum()
    loss.backward()
    return loss.detach(), model


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_remat_is_the_same_step(fused, dtype):
    """``remat: true`` on either route, float32 and bf16: the loss,
    every gradient, every running statistic and ``num_batches_tracked``
    (1: updated once, not again by the recomputation) equal to
    ``remat: false``'s; the fused route runs its forward passes twice
    under remat (the recomputation), its backward passes once."""
    knobs = {"fused_train": fused}
    if dtype:
        knobs["dtype"] = dtype
    conf = _conf("mdtc", **knobs)
    g = torch.Generator().manual_seed(4)
    state = init_model(conf, g).state_dict()
    feats = torch.randn((3, 30, conf["input_dim"]), generator=g)
    cot = torch.randn((3, 30, 1), generator=g)
    calls = []

    def count(name, *args):
        calls.append(name)
        return PASSES[name].plain(*args)

    from wekws_tpu_torch.ops import fused_mdtc_train as fmt

    saved, fmt._block_run = fmt._block_run, count
    try:
        loss0, plain = _remat_run(conf, state, feats, cot)
        n_plain = len(calls)
        remat_conf = dict(conf, backbone=dict(conf["backbone"], remat=True))
        loss1, remat = _remat_run(remat_conf, state, feats, cot)
    finally:
        fmt._block_run = saved
    blocks = 1 + 2 * 2
    if fused:
        assert n_plain == 8 * blocks
        assert calls[n_plain:].count("f1") == 2 * blocks
        assert calls[n_plain:].count("b4") == blocks
    else:
        assert not calls
    assert torch.equal(loss0, loss1)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), name
        if name.endswith("num_batches_tracked"):
            assert int(b) == 1, name


@pytest.mark.parametrize("b,groups,bn_dtype", [
    (8, 4, None),        # four groups of two rows
    (6, 4, None),        # 6 % 4 != 0: one group, as JAX falls back
    (8, 2, "bfloat16"),  # bf16 input and output, statistics float32
])
def test_ghost_batchnorm_matches_jax(b, groups, bn_dtype):
    """``GhostBatchNorm`` against JAX's on the same x (bf16 where
    ``bn_dtype`` is): the training output (1e-5 of its scale at
    float32, one bf16 step, 2^-8, of it at bf16), x's gradient (the
    same; at bf16 rounded to bf16 as JAX's is), the scale's and bias's
    (1e-5 at float32; at bf16 each is the gradient of a bf16 operand,
    a sum that both round to bf16 and XLA also sums in bf16: four bf16
    steps, 2^-6), the running statistics 1e-6 and the eval output;
    ``num_batches_tracked`` 1; the factory's choice."""
    rng = np.random.default_rng(b + groups)
    x = (rng.standard_normal((b, 12, 6)) * 2 + 1).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(6)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(6)).astype(np.float32)
    var0 = (1.0 + rng.random(6)).astype(np.float32)
    jdt = jnp.bfloat16 if bn_dtype else None
    tdt = torch.bfloat16 if bn_dtype else None
    xj = jnp.asarray(x).astype(jdt) if jdt else jnp.asarray(x)
    gbn = JaxGhostBatchNorm(num_groups=groups, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}

    def f(pp, xx):
        y, upd = gbn.apply({"params": pp,
                            "batch_stats": variables["batch_stats"]}, xx,
                           use_running_average=False,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd["batch_stats"])

    (_, (y_j, st_j)), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], xj)
    y_eval_j = gbn.apply(variables, xj, use_running_average=True)

    bn = GhostBatchNorm(6, groups, tdt).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x)
    xt = (xt.to(tdt) if tdt else xt).requires_grad_()
    y = bn(xt)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    tol = 2.0 ** -8 if bn_dtype else 1e-5
    assert y.dtype == (tdt or torch.float32) and xt.grad.dtype == xt.dtype
    assert _share(y.detach().float(), np.asarray(y_j, np.float32)) <= tol
    assert _share(xt.grad.float(), np.asarray(gx_j, np.float32)) <= tol
    for got, want in ((bn.weight.grad, gp_j["scale"]),
                      (bn.bias.grad, gp_j["bias"])):
        assert _share(got, want) <= (2.0 ** -6 if bn_dtype else tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(st_j["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(st_j["var"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        y_eval = bn(xt)
    assert y_eval.dtype == y.dtype
    assert _share(y_eval.float(), np.asarray(y_eval_j, np.float32)) <= tol
    assert int(bn.num_batches_tracked) == 1
    from wekws_tpu_torch.models.layers import batch_norm

    assert type(batch_norm(6, groups)) is GhostBatchNorm
    assert type(batch_norm(6, 1)) is type(batch_norm(6)) is BatchNorm


@pytest.mark.parametrize("ghost_bn", [2, 1])
def test_ghost_bn_bypasses_the_fused_route(ghost_bn, monkeypatch):
    """``ghost_bn`` set (2, and also 1, as JAX's ``not self.ghost_bn``)
    turns ``fused_train``'s route off: no fused block runs; the MDTC
    with ``ghost_bn: 2`` and ``fused_train`` against JAX's (B=4: two
    groups of two rows): training output 1e-4, running statistics 1e-4,
    gradients 1e-4 of max(1, max |grad|), as the float32 fused-model
    test holds them."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused block ran with ghost_bn set")

    monkeypatch.setattr(port_mdtc, "fused_tcn_block_train", refuse)
    conf = _conf("mdtc", fused_train=True, ghost_bn=ghost_bn)
    feats, lengths, cot = _inputs(conf)
    variables = jax_init_model(conf).init(
        jax.random.PRNGKey(0), jnp.asarray(feats),
        lengths=jnp.asarray(lengths))
    out_j, stats_j, grads_j = _jax_step(conf, variables, feats, lengths, cot)
    model, out = _port_step(conf, variables, feats, lengths, cot)
    blocks = [m for m in model.modules() if isinstance(m, TCNBlock)]
    assert blocks and all(blk.fused_train for blk in blocks)
    bn_type = GhostBatchNorm if ghost_bn > 1 else BatchNorm
    assert all(type(m) is bn_type for m in model.modules()
               if isinstance(m, BatchNorm))
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=1e-4)
    ref = model_from_jax(jax.device_get(variables["params"]), stats_j, conf)
    bufs = dict(model.named_buffers())
    for name, buf in ref.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(bufs[name].numpy(), buf.numpy(),
                                       atol=1e-4, err_msg=name)
    want = grads_from_jax(jax.device_get(grads_j), conf)
    for name, p in model.named_parameters():
        scale = max(float(want[name].abs().max()), 1.0)
        assert float((p.grad - want[name]).abs().max()) <= 1e-4 * scale, name


FLAGSHIP = {  # bench.py's FLAGSHIP_MODEL_CONF at bench.py's bf16 default
    "input_dim": 40, "output_dim": 1, "hidden_dim": 64, "dtype": "bfloat16",
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "mdtc", "num_stack": 4, "stack_size": 4,
                 "kernel_size": 5, "hidden_dim": 64, "causal": True,
                 "bn_dtype": "bfloat16"},
}
FSMN_CTC = {  # bench.py bench_ctc's model at its bf16 default
    "input_dim": 400, "output_dim": 2599, "hidden_dim": 128,
    "dtype": "bfloat16", "preprocessing": {"type": "none"},
    "backbone": {"type": "fsmn", "input_affine_dim": 140, "num_layers": 4,
                 "linear_dim": 250, "proj_dim": 128, "left_order": 10,
                 "right_order": 2, "left_stride": 1, "right_stride": 1,
                 "output_affine_dim": 140},
    "classifier": {"type": "identity", "dropout": 0.1},
    "activation": {"type": "identity"},
}


def _synthetic_scale_model():
    import os

    import yaml

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "synthetic_scale", "conf",
        "mdtc.yaml")
    with open(path) as f:
        conf = yaml.safe_load(f)
    # bin.train's completion: the features' width, one keyword
    return dict(conf["model"], output_dim=1,
                input_dim=conf["dataset_conf"]["fbank_conf"]["num_mel_bins"])


LISTED = {
    "flagship_bf16": lambda: FLAGSHIP,
    "flagship_bf16_fused": lambda: dict(FLAGSHIP, backbone=dict(
        FLAGSHIP["backbone"], fused_train=True)),
    "flagship_remat": lambda: dict(FLAGSHIP, backbone=dict(
        FLAGSHIP["backbone"], remat=True, fused_train=True)),
    "flagship_ghost_bn_4": lambda: dict(FLAGSHIP, backbone=dict(
        FLAGSHIP["backbone"], ghost_bn=4, fused_train=True)),
    "fsmn_ctc_bf16": lambda: FSMN_CTC,
    "synthetic_scale_mdtc": _synthetic_scale_model,
}


@pytest.mark.parametrize("name", sorted(LISTED))
def test_listed_configs_build_and_train(name):
    """Every knob configuration of the JAX package's defaults builds and
    takes a ``Trainer`` step on the CPU (B=4 x 0.5 s): the loss finite,
    the parameters, their gradients and Adam's moments float32."""
    conf = dict(LISTED[name]())
    fsmn = conf["backbone"]["type"] == "fsmn"
    dataset = {"feats_type": "fbank", "fbank_conf": {
        "num_mel_bins": 80 if fsmn else 40, "frame_shift": 10,
        "frame_length": 25, "dither": 0.0}}
    if fsmn:
        dataset.update(context_expansion=True,
                       context_expansion_conf={"left": 2, "right": 2},
                       frame_skip=3)
    model = init_model(conf, torch.Generator().manual_seed(0))
    trainer = Trainer(model, DeviceFeaturePipeline.from_conf(dataset),
                      DeviceFeaturePipeline.from_conf(dataset,
                                                      training=False),
                      "ctc" if fsmn else "max_pooling", device="cpu")
    rng = np.random.default_rng(1)
    batch = {"waves": (rng.standard_normal((4, 8000)) * 300).astype(
                 np.float32),
             "wave_lengths": np.full((4,), 8000, np.int32),
             "target": (np.arange(4) % 2 - 1).astype(np.int32),
             "target_lengths": np.ones((4,), np.int32)}
    if fsmn:
        batch["target"] = rng.integers(1, 50, (4, 3)).astype(np.int32)
        batch["target_lengths"] = np.full((4,), 3, np.int32)
    state = trainer.init_state()
    state, metrics = trainer.train_step(state, batch, 0, 1e-3)
    assert np.isfinite(float(metrics["loss"]))
    for p in state.model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    opt = state.optimizer
    assert opt.mu.dtype == opt.nu.dtype == torch.float32
    assert torch.isfinite(opt.mu).all()
