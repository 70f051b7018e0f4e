"""Port fused FSMN (ops/fused_fsmn.py plain version, ops/serving.py
build_fused_forward / build_fused_stream) against the JAX package's
Pallas kernel in interpret mode and its build_fused_* functions, on the
same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.ops.fused_fsmn import extract_fsmn_weights as jax_extract
from wekws_tpu.ops.fused_fsmn import fused_fsmn_forward as jax_fsmn_forward
from wekws_tpu.ops.fused_fsmn import fused_fsmn_layers as jax_fsmn_layers
from wekws_tpu.ops.serving import build_fused_forward as jax_build_forward
from wekws_tpu.ops.serving import build_fused_stream as jax_build_stream
from wekws_tpu_torch.ops.fused_fsmn import (
    MAX_SHARED_BYTES,
    cluster_slices,
    extract_fsmn_weights,
    fused_fsmn_forward,
    fused_fsmn_layers,
    fused_fsmn_layers_plain,
    fused_fsmn_smem_bytes,
    init_fsmn_cache,
    pack_fsmn_weights,
    slice_width,
)
from wekws_tpu_torch.ops.serving import build_fused_forward, build_fused_stream
from wekws_tpu_torch.tools.from_jax import model_from_jax

# the JAX suite's own bound for its fused kernels against flax
ATOL, RTOL = 2e-4, 1e-3
IDIM, ODIM = 20, 8


def _conf(rorder=2, lstride=1, rstride=1):
    return {
        "input_dim": IDIM, "output_dim": ODIM, "hidden_dim": 40,
        "preprocessing": {"type": "none"},
        "backbone": {"type": "fsmn", "input_affine_dim": 24,
                     "num_layers": 3, "linear_dim": 40, "proj_dim": 16,
                     "left_order": 5, "right_order": rorder,
                     "left_stride": lstride, "right_stride": rstride,
                     "output_affine_dim": 24},
        "classifier": {"type": "identity", "dropout": 0.0},
        "activation": {"type": "identity"},
    }


def _jax_and_port(conf, seed=0):
    model = jax_init_model(conf)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, 8, IDIM), np.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params}, model_from_jax(params, None, conf)


@pytest.mark.parametrize("rorder,lstride", [(2, 1), (0, 1), (2, 2)])
def test_extract_weights_equal_jax(rorder, lstride):
    """Thirteen tensors, the dummy ``wr`` row of ``rorder == 0`` too."""
    jmodel, variables, pmodel = _jax_and_port(_conf(rorder, lstride))
    want = jax_extract(jmodel.backbone, variables["params"]["backbone"])
    got = extract_fsmn_weights(pmodel.backbone)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rorder,lstride,rstride,t", [
    (2, 1, 1, 30), (0, 1, 1, 30), (2, 2, 2, 30), (2, 1, 1, 4), (2, 2, 2, 1),
])
def test_plain_matches_pallas_interpret(rng, rorder, lstride, rstride, t):
    """Layer chain from a random carried cache against the Pallas kernel
    in interpret mode: outputs and new cache.  T = 4 and 1 are shorter
    than P (6 and 12), where the new cache mixes old cache rows and new
    frames."""
    conf = _conf(rorder, lstride, rstride)
    _, _, pmodel = _jax_and_port(conf, seed=1)
    w = extract_fsmn_weights(pmodel.backbone)[4:9]
    pad = 4 * lstride + rorder * rstride
    x = rng.standard_normal((3, t, 40)).astype(np.float32)
    cache = rng.standard_normal((3, 3, pad, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y, want_c = jax_fsmn_layers(
            jnp.asarray(x), jnp.asarray(cache),
            *[jnp.asarray(a.numpy()) for a in w], 5, rorder, lstride,
            rstride)
    before = fused_fsmn_layers.launches
    got_y, got_c = fused_fsmn_layers(
        torch.from_numpy(x), torch.from_numpy(cache), *w, 5, rorder, lstride,
        rstride)
    assert fused_fsmn_layers.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)


def test_fused_forward_chunked_equals_whole_and_jax(rng):
    """``fused_fsmn_forward`` (in/out linears around the chain) whole and
    in 8-frame chunks, against JAX's in interpret mode."""
    jmodel, variables, pmodel = _jax_and_port(_conf(), seed=2)
    x = rng.standard_normal((2, 32, IDIM)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, want_c = jax_fsmn_forward(
            jmodel.backbone, variables["params"]["backbone"], jnp.asarray(x))
    xt = torch.from_numpy(x)
    full, full_c = fused_fsmn_forward(pmodel.backbone, xt)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(full_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)
    cache, outs = None, []
    for s in range(0, 32, 8):
        y, cache = fused_fsmn_forward(pmodel.backbone, xt[:, s:s + 8], cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(cache, full_c, atol=1e-5, rtol=1e-5)


def test_fused_forward_and_stream_match_jax(rng):
    """FSMN with no preprocessing, identity head and the engine's
    softmax: fused forward and 8-frame stream against JAX's (in interpret
    mode) and against the module forward."""
    conf = _conf()
    jmodel, variables, pmodel = _jax_and_port(conf, seed=3)
    x = rng.standard_normal((2, 32, IDIM)).astype(np.float32)
    lengths = np.asarray([32, 20])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_build_forward(jmodel, variables, softmax=True)(
            jnp.asarray(x), jnp.asarray(lengths)))
        jstep, jinit = jax_build_stream(jmodel, variables, softmax=True)
        jcache, jouts = jinit(2), []
        for s in range(0, 32, 8):
            y, jcache = jstep(jnp.asarray(x[:, s:s + 8]), jcache)
            jouts.append(np.asarray(y))
    got = build_fused_forward(pmodel, softmax=True, device="cpu")(x, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    with torch.inference_mode():
        module, _ = pmodel(torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths), softmax=True)
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=1e-5,
                               rtol=1e-5)
    step, init_cache = build_fused_stream(pmodel, softmax=True, device="cpu")
    cache, outs = init_cache(2), []
    assert tuple(cache.shape) == tuple(jcache.shape) == (3, 2, 6, 16)
    for s in range(0, 32, 8):
        y, cache = step(x[:, s:s + 8], cache)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.concatenate(jouts, axis=1), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=ATOL,
                               rtol=RTOL)


def test_wrapper_checks_its_inputs():
    _, _, pmodel = _jax_and_port(_conf())
    w = extract_fsmn_weights(pmodel.backbone)[4:9]
    x = torch.zeros((2, 8, 40))
    with pytest.raises(ValueError, match="cache"):
        fused_fsmn_layers(x, init_fsmn_cache(3, 2, 5, 16), *w, 5, 2)
    with pytest.raises(ValueError, match="proj_w"):
        fused_fsmn_layers(torch.zeros((2, 8, 41)),
                          init_fsmn_cache(3, 2, 6, 16), *w, 5, 2)
    y, c = fused_fsmn_layers_plain(x, init_fsmn_cache(3, 2, 6, 16), *w, 5, 2)
    assert y.shape == (2, 8, 40) and c.shape == (3, 2, 6, 16)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("n", [1, 5, 16, 40, 70, 128, 140, 250, 256])
def test_cluster_slices_cover_every_column_once(n, cluster):
    """The kernel's cluster of blocks splits the proj channels and the
    affine columns into slices of one width, a multiple of 4 (16-byte
    copies) and at most 32 (the kernel's lanes); the ragged last owner
    and the empty ones past it included, every column is owned once."""
    slices = cluster_slices(n, cluster)
    width = slice_width(n, cluster)
    assert len(slices) == cluster and width % 4 == 0
    if n <= 256:
        assert width <= 32
    owned = [c for b, e in slices for c in range(b, e)]
    assert owned == list(range(n))
    assert all(e - b <= width for b, e in slices)
    assert all(b % 4 == 0 for b, e in slices if e > b)
    if (n, cluster) == (250, 8):  # seven of 32 and one of 26
        assert [e - b for b, e in slices] == [32] * 7 + [26]


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("ld,pd,lorder,rorder,stride", [
    (250, 128, 10, 2, 1),   # the hi_xiaowen recipe
    (256, 256, 10, 2, 1),   # the widest the kernel takes
    (40, 16, 5, 2, 2),
])
def test_fsmn_smem_fits_a_block(ld, pd, lorder, rorder, stride, cluster):
    """One block's shared memory (two weight buffers of its slices, a
    16-row tile of cur, two o buffers, three windows, the partial sums,
    two mbarriers)
    stays under a block's 227 KB at every width the kernel takes, and at
    the recipe's widths two blocks share an SM (233,472 bytes, 1,024
    reserved a block)."""
    smem = fused_fsmn_smem_bytes(ld, pd, lorder, rorder, stride, stride,
                                 cluster)
    assert smem <= MAX_SHARED_BYTES
    pc, lc = slice_width(pd, cluster), slice_width(ld, cluster)
    ldp, pdp = -(-ld // 4) * 4, -(-pd // 4) * 4
    pad = (lorder - 1) * stride + rorder * stride
    weights = 2 * (ldp * pc + pdp * lc + (lorder + rorder) * pc + lc)
    assert smem == 4 * (weights + 16 * ldp + 2 * 16 * pdp
                        + 3 * (pad + 16) * pc + 4 * 16 * 32) + 16
    if (ld, pd) == (250, 128):
        assert 2 * (smem + 1024) <= 233472


def test_pack_fsmn_weights_holds_each_slice(rng):
    """Packed weights hold block k's column slice of every layer as one
    contiguous run, zero past the matrix's last column."""
    proj_w = torch.from_numpy(rng.standard_normal((3, 250, 128))
                              .astype(np.float32))
    aff_w = torch.from_numpy(rng.standard_normal((3, 128, 250))
                             .astype(np.float32))
    pp, pa = pack_fsmn_weights(proj_w, aff_w)
    assert pp.shape == (3, 8, 250, 16) and pa.shape == (3, 8, 128, 32)
    assert pp.is_contiguous() and pa.is_contiguous()
    for k, (b, e) in enumerate(cluster_slices(250, 8)):
        torch.testing.assert_close(pa[:, k, :, :e - b], aff_w[:, :, b:e],
                                   atol=0, rtol=0)
        assert not pa[:, k, :, e - b:].any()
    for k, (b, e) in enumerate(cluster_slices(128, 8)):
        torch.testing.assert_close(pp[:, k], proj_w[:, :, b:e], atol=0,
                                   rtol=0)


def test_wrapper_checks_its_packed_weights():
    """Packed weights of the wrong shape raise before anything runs; on
    the CPU valid packed weights change nothing (the plain version
    ignores them)."""
    _, _, pmodel = _jax_and_port(_conf())
    w = extract_fsmn_weights(pmodel.backbone)[4:9]
    x = torch.rand((2, 8, 40))
    cache = init_fsmn_cache(3, 2, 6, 16)
    with pytest.raises(ValueError, match="packed proj_w"):
        fused_fsmn_layers(x, cache, *w, 5, 2,
                          packed=(w[0][:, None].contiguous(), w[3]))
    got = fused_fsmn_layers(x, cache, *w, 5, 2,
                            packed=pack_fsmn_weights(w[0], w[3]))
    want = fused_fsmn_layers_plain(x, cache, *w, 5, 2)
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
