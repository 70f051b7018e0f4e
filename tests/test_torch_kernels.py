"""The port's CUDA kernels against their plain PyTorch versions.

Imports nothing of the JAX package, so it also runs on a GPU machine
without flax: ``python -m pytest -m cuda tests/test_torch_kernels.py``.
Without a GPU each test skips: a CUDA kernel has no CPU mode.  The
full-width check on the card is ``chip_smoke.py``."""

import pytest
import torch

from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.ops.fused_mdtc import (
    extract_mdtc_weights,
    fused_mdtc_forward,
    fused_mdtc_forward_plain,
    fused_mdtc_stream,
    fused_mdtc_stream_plain,
)

CONF = {
    "input_dim": 40, "output_dim": 1, "hidden_dim": 32,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 3,
                 "kernel_size": 5, "hidden_dim": 32, "causal": True},
}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 64, 70, 130])
def test_fused_mdtc_kernel_matches_plain(t):
    """Whole tiles, a partial last tile and a short streaming chunk;
    bound 1e-4 abs + 1e-4 rel (fp32, another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(t)
    model = init_model(CONF, g)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(1.0 + 0.5 * torch.rand(buf.shape, generator=g))
    *stacks, dil = extract_mdtc_weights(model.backbone)
    w = [s.cuda() for s in stacks]
    x = torch.randn((3, t, 32), generator=g).cuda()
    before = fused_mdtc_forward.launches
    got = fused_mdtc_forward(x, *w, dil, 5, 3)
    assert fused_mdtc_forward.launches == before + 1
    want = fused_mdtc_forward_plain(x, *w, dil, 5, 3)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    cache = torch.randn((len(dil), 3, 4 * max(dil), 32), generator=g).cuda()
    got_y, got_c = fused_mdtc_stream(x, cache, *w, dil, 5, 3)
    want_y, want_c = fused_mdtc_stream_plain(x, cache, *w, dil, 5, 3)
    torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 20, 64, 70, 130])
@pytest.mark.parametrize("dilation", [1, 8])
def test_fused_train_passes_match_plain(t, dilation):
    """Each of the eight training passes on identical inputs (B=3):
    whole 64-frame tiles, partial last tiles and causal halos longer
    than a tile or than the utterance; at T=70 every kernel width, K=8
    at C=128, and B x T = 210 frames, which no tile of F2, F3, B2 or B3
    (64 or 32 rows over the flattened frames) nor B1's rows divide.
    Their tiles span utterances: at T=70 and T=130 a tile holds the end
    of one and the start of the next, at T=8 and T=20 a tile holds all
    three, shorter than dilation 8's halo of 32 frames (there at C = 32
    and 128 too); F1's, F2's and F3's conv must not reach into the
    earlier utterance.  B3 hands its ds0
    to B4; every pass is bitwise equal when launched twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        compare_pass,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    g = torch.Generator().manual_seed(100 * t + dilation)
    combos = ((32, 5), (64, 5), (128, 5), (128, 8)) if t == 70 else (
        ((32, 5), (64, 5), (128, 5)) if t == 20 else ((64, 5),))
    for c, k in combos:
        p, x, dy = seeded_block_inputs(g, 3, t, c, k, "cuda")
        calls = trace_pass_inputs(x, p, dy, dilation)
        assert len(calls["b3"]) == 10 and len(calls["b4"]) == 8
        for name, args in calls.items():
            before = PASSES[name].launches
            got = PASSES[name](*args)
            again = PASSES[name](*args)
            assert PASSES[name].launches == before + 2
            torch.cuda.synchronize()
            # (B, T, C) outputs 1e-4 abs + 1e-4 rel, sums 1e-3 of the
            # largest of the pass's sums
            compare_pass(name, got, PASSES[name].plain(*args))
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            for a, b in zip(got, again):
                assert torch.equal(a, b), f"{name} is not reproducible"


def _check_without_window(name):
    """At C=128 a halo of (5-1) x 16 = 64 frames leaves no room for
    F3's staged window of x beside its weights and tiles, so F3 and F2
    (one rule for both) read their taps from device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        compare_pass,
        seeded_block_inputs,
        tile_smem_bytes,
        trace_pass_inputs,
    )

    assert tile_smem_bytes(name, 128, 64) == tile_smem_bytes(name, 128,
                                                             10 ** 6)
    g = torch.Generator().manual_seed(16)
    p, x, dy = seeded_block_inputs(g, 3, 130, 128, 5, "cuda")
    args = trace_pass_inputs(x, p, dy, 16)[name]
    got = PASSES[name](*args)
    again = PASSES[name](*args)
    torch.cuda.synchronize()
    compare_pass(name, got, PASSES[name].plain(*args))
    for a, b in zip(got, again):
        assert torch.equal(a, b), f"{name} is not reproducible"


@pytest.mark.cuda
def test_fused_train_f3_without_its_window():
    """F3 at C=128, dilation 16 reads its taps from device memory:
    outputs within 1e-4 abs + 1e-4 rel of the plain version's, sums
    within 1e-3 of the largest, bitwise equal when launched twice."""
    _check_without_window("f3")


@pytest.mark.cuda
def test_fused_train_f2_without_its_window():
    """F2 at C=128, dilation 16 reads its taps from device memory, as
    F3 does: sums within 1e-3 of the largest of the plain version's,
    bitwise equal when launched twice."""
    _check_without_window("f2")


@pytest.mark.cuda
def test_fused_train_block_gradients_match_autograd():
    """The fused block (the autograd Function over the eight kernels)
    against autograd of the unfused module block, both on the card
    (fp32): y and dx 1e-4 abs + 1e-4 rel, the twelve parameter
    gradients within 1e-3 of the largest |grad| (``compare_sums``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.models.mdtc import TCNBlock
    from wekws_tpu_torch.ops.fused_mdtc_train import PASSES, compare_sums

    g = torch.Generator().manual_seed(7)
    blocks = [TCNBlock(64, 64, 5, 4, fused_train=fused).cuda().train()
              for fused in (True, False)]
    with torch.no_grad():
        for prm in blocks[0].parameters():
            prm.copy_(torch.randn(prm.shape, generator=g).cuda() * 0.3)
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.randn((5, 130, 64), generator=g).cuda()
    dy = torch.randn((5, 130, 64), generator=g).cuda()
    before = PASSES["b4"].launches
    outs = []
    for blk in blocks:
        xi = x.clone().requires_grad_()
        y, _ = blk(xi, None)
        (y * dy).sum().backward()
        outs.append((y.detach(), xi.grad))
    assert PASSES["b4"].launches == before + 1
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    compare_sums("grads", [p.grad for p in blocks[0].parameters()],
                 [p.grad for p in blocks[1].parameters()])


def test_compare_pass_holds_each_output_to_its_bound():
    """The comparator the card checks use: a pass against itself is
    exact; an output off by more than 1e-4 abs + 1e-4 rel, or a sum
    off by more than 1e-3 of its group's largest, fails."""
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        compare_pass,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    g = torch.Generator().manual_seed(3)
    p, x, dy = seeded_block_inputs(g, 2, 9, 8, 3, "cpu")
    calls = trace_pass_inputs(x, p, dy, 2)
    r, w, s, ss = PASSES["f3"].plain(*calls["f3"])
    assert compare_pass("f3", (r, w, s, ss), (r, w, s, ss)) == 0.0
    with pytest.raises(AssertionError, match="f3"):
        compare_pass("f3", (r, w + 1e-2, s, ss), (r, w, s, ss))
    scale = max(float(s.abs().max()), float(ss.abs().max()), 1.0)
    with pytest.raises(AssertionError, match="f3"):
        compare_pass("f3", (r, w, s + 2e-3 * scale, ss), (r, w, s, ss))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,widths,dilation", [
    (3, 8, (64,), 1), (3, 8, (64,), 8),
    (3, 70, (32, 64, 128), 1), (3, 70, (32, 64, 128), 8),
    (3, 198, (64,), 1), (3, 198, (64,), 8),
    # a ragged last tile: 385 rows, no multiple of F3's 128 or B2's 64
    (5, 77, (64,), 4),
    # C = 32 and C = 128 alone
    (2, 150, (32,), 2), (2, 150, (128,), 2),
    # F3's window does not fit: it reads its taps from device memory
    # (C = 128, H = 4 x 40 = 160; C = 64, H = 4 x 169 = 676)
    (3, 200, (128,), 40), (2, 700, (64,), 169),
    # B3's window fits one block an SM, not two (C = 64, H = 4 x 60 =
    # 240)
    (2, 300, (64,), 60),
])
def test_fused_train_bf16_variants_match_plain(b, t, widths, dilation):
    """The bf16-operand variants of F2, F3, B2 and B3 on identical
    inputs (B x T at each width in ``widths``) against their bf16 plain
    versions (``compare_pass`` at bf16: (B, T, C) outputs within
    BF16_OUT_TOL of their scale with at most BF16_OFF_SHARE of them
    beyond 1e-4, the sums BF16_SUM_TOL of their group's largest); F3's r is
    bf16; each launch counts in ``.bf16_launches``, not ``.launches``;
    bitwise equal when launched twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_PASSES,
        BF16_SUM_TOL,
        PASSES,
        b3_bf16_staged,
        blocks_per_sm,
        compare_pass,
        f3_bf16_staged,
        seeded_block_inputs,
        tile_smem_bytes,
        trace_pass_inputs,
    )

    if (t, dilation) == (200, 40):
        assert not f3_bf16_staged(128, 160)
        assert not b3_bf16_staged(128, 160)
    if (t, dilation) == (700, 169):
        assert not f3_bf16_staged(64, 676)
        assert not b3_bf16_staged(64, 676)
    if (t, dilation) == (300, 60):
        assert b3_bf16_staged(64, 240)
        assert blocks_per_sm(tile_smem_bytes("b3", 64, 240, "bfloat16"),
                             64) == 1
    g = torch.Generator().manual_seed(200 * t + dilation + 1000 * (b != 3))
    for c in widths:
        p, x, dy = seeded_block_inputs(g, b, t, c, 5, "cuda")
        calls = trace_pass_inputs(x, p, dy, dilation,
                                  precision="bfloat16")
        assert calls["f3"][-1] == "bfloat16"
        for name in BF16_PASSES:
            args = calls[name]
            before = (PASSES[name].launches, PASSES[name].bf16_launches)
            got = PASSES[name](*args)
            again = PASSES[name](*args)
            assert (PASSES[name].launches,
                    PASSES[name].bf16_launches) == (before[0], before[1] + 2)
            torch.cuda.synchronize()
            compare_pass(name, got, PASSES[name].plain(*args), "bfloat16",
                         BF16_SUM_TOL[name])
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            if name == "f3":
                assert got[0].dtype == torch.bfloat16
            for one, two in zip(got, again):
                assert torch.equal(one, two), f"{name} is not reproducible"


@pytest.mark.cuda
def test_fused_train_bf16_block_matches_plain_passes():
    """The fused block at ``precision="bfloat16"`` through its kernels
    against the same block through the plain passes, both on the card:
    y within 4e-3 of its scale (bf16 ties, as
    tests/test_torch_mixed_precision.py holds it against JAX), the
    statistics 5e-4 of theirs, dx 4e-3 of its scale (dy zero near the
    residual ReLU's kink, as phase 6 of chip_smoke.py); the forward
    launches F2's and F3's bf16 variants once, the backward B2's and
    B3's, and no float32 kernel of the four runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_PASSES,
        PASSES,
        PASS_IDS,
        _kernel_layout,
        block_forward,
        fused_tcn_block_train,
        plain_passes,
        seeded_block_inputs,
    )

    g = torch.Generator().manual_seed(9)
    p, x, dy = seeded_block_inputs(g, 8, 130, 64, 5, "cuda")
    # dy zero where the residual ReLU's input lies within 1e-2 of its
    # kink: a bf16 tie there would flip the gate and move dx by dy
    _, _, w, v = block_forward(x, _kernel_layout(p), 2, 1e-5,
                               lambda n, *a: PASSES[n].plain(*a),
                               "bfloat16")
    dy = dy.masked_fill((w * v["a2"] + v["c2"] + x).abs() < 1e-2, 0.0)

    def block():
        xi = x.clone().requires_grad_()
        y, st = fused_tcn_block_train(xi, p, 5, 2, precision="bfloat16")
        (y * dy).sum().backward()
        return y.detach(), st, xi.grad

    before = {n: (PASSES[n].launches, PASSES[n].bf16_launches)
              for n in BF16_PASSES}
    y, st, dx = block()
    assert all((PASSES[n].launches, PASSES[n].bf16_launches)
               == (before[n][0], before[n][1] + 1) for n in BF16_PASSES)
    with plain_passes(*PASS_IDS):
        y0, st0, dx0 = block()
    torch.cuda.synchronize()
    for got, want in ((y, y0), (dx, dx0)):
        assert float((got - want).abs().max()) <= 4e-3 * float(
            want.abs().max())
    for key in st0:
        err = float((st[key] - st0[key]).abs().max())
        assert err <= 5e-4 * float(st0[key].abs().max()), key


def test_compare_pass_holds_bf16_outputs_to_their_bound():
    """The comparator at bf16: a pass against itself is exact; a few
    elements one bf16 step off (ties) pass; an output whose rounding is
    missing (every element off), or one element off by more than
    BF16_OUT_TOL of the scale, or a dtype that differs, fails."""
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_OUT_TOL,
        PASSES,
        compare_pass,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    g = torch.Generator().manual_seed(5)
    p, x, dy = seeded_block_inputs(g, 2, 40, 8, 3, "cpu")
    calls = trace_pass_inputs(x, p, dy, 2, precision="bfloat16")
    r, w, s, ss = PASSES["f3"].plain(*calls["f3"])
    assert r.dtype == torch.bfloat16
    assert compare_pass("f3", (r, w, s, ss), (r, w, s, ss), "bfloat16") == 0.0
    tie = w.clone()
    tie[0, 0, :2] *= 1 + 2.0 ** -8
    compare_pass("f3", (r, tie, s, ss), (r, w, s, ss), "bfloat16")
    unrounded = PASSES["f3"].plain(*calls["f3"][:-1])  # float32 operands
    with pytest.raises(AssertionError, match="f3"):
        compare_pass("f3", (r, unrounded[1], s, ss), (r, w, s, ss),
                     "bfloat16")
    far = w.clone()
    far[1, 3, 0] += 2 * BF16_OUT_TOL * float(w.abs().max())
    with pytest.raises(AssertionError, match="f3"):
        compare_pass("f3", (r, far, s, ss), (r, w, s, ss), "bfloat16")
    with pytest.raises(AssertionError, match="dtype"):
        compare_pass("f3", (r.float(), w, s, ss), (r, w, s, ss), "bfloat16")


@pytest.mark.parametrize("name", ["f2", "f3", "b2", "b3"])
def test_compare_pass_rejects_unrounded_bf16_operands(name):
    """The control of the bf16 check: the plain version with float32
    operands on the same bf16 inputs fails ``compare_pass`` at bf16
    (F2 and B2 return only sums, so their sums' bound must catch it);
    the bf16 plain version against itself passes, and so does a sum off
    by half of the pass's BF16_SUM_TOL of its group's largest, where one
    off by twice that fails."""
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_SUM_TOL,
        PASSES,
        compare_pass,
        seeded_block_inputs,
        trace_pass_inputs,
    )

    g = torch.Generator().manual_seed(5)
    p, x, dy = seeded_block_inputs(g, 2, 40, 8, 3, "cpu")
    args = trace_pass_inputs(x, p, dy, 2, precision="bfloat16")[name]
    want = PASSES[name].plain(*args)
    tol = BF16_SUM_TOL[name]
    assert compare_pass(name, want, want, "bfloat16", tol) == 0.0
    unrounded = [u.to(w.dtype) for u, w in zip(
        PASSES[name].plain(*args[:-1], "float32"), want)]
    with pytest.raises(AssertionError, match=name):
        compare_pass(name, tuple(unrounded), want, "bfloat16", tol)
    i = next(i for i, w in enumerate(want) if w.dim() != 3)
    scale = max([float(w.abs().max()) for w in want if w.dim() != 3] + [1.0])
    for factor, fails in ((0.5, False), (2.0, True)):
        moved = list(want)
        moved[i] = want[i] + factor * tol * scale
        if fails:
            with pytest.raises(AssertionError, match=name):
                compare_pass(name, tuple(moved), want, "bfloat16", tol)
        else:
            compare_pass(name, tuple(moved), want, "bfloat16", tol)


def _ds_tcn_weights(g, n_layers, k, c):
    return [(torch.randn(shape, generator=g) * scale).cuda()
            for shape, scale in (((n_layers, k, c), 0.3), ((n_layers, c), 0.1),
                                 ((n_layers, c, c), c ** -0.5),
                                 ((n_layers, c), 0.1))]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 70, 130, 198])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_ds_tcn_kernel_matches_plain(b, t):
    """A single frame, a streaming chunk shorter than pad_max, partial
    and whole sub-tiles and T=198 (the hey_snips utterance: with K=8 and
    dilations 1-8 the halo of 56 rows spans two blocks), from a random
    carried cache, at every width the kernel takes (48 with idle
    threads, 256 with W in slices): output and new cache 1e-4 abs +
    1e-4 rel (fp32, another summation order), bitwise equal from launch
    to launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn, fused_ds_tcn_plain

    g = torch.Generator().manual_seed(10 * t + b)
    for c, k, dil in ((64, 8, (1, 2, 4, 8)), (48, 8, (1, 2, 4, 8)),
                      (256, 8, (1, 2, 4, 8)), (32, 5, (1, 2)),
                      (128, 8, (1, 2))):
        n_layers, pad = len(dil), (k - 1) * max(dil)
        w = _ds_tcn_weights(g, n_layers, k, c)
        x = torch.randn((b, t, c), generator=g).cuda()
        cache = torch.randn((n_layers, b, pad, c), generator=g).cuda()
        before = fused_ds_tcn.launches
        got_y, got_c = fused_ds_tcn(x, cache, *w, dil, k)
        again_y, again_c = fused_ds_tcn(x, cache, *w, dil, k)
        assert fused_ds_tcn.launches == before + 2
        want_y, want_c = fused_ds_tcn_plain(x, cache, *w, dil, k)
        torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=1e-4)
        assert torch.equal(got_y, again_y) and torch.equal(got_c, again_c)


@pytest.mark.cuda
def test_fused_ds_tcn_raises_outside_its_widths():
    """A width outside KERNEL_CHANNELS raises on the card, never falls
    back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_tcn import KERNEL_CHANNELS, fused_ds_tcn

    assert KERNEL_CHANNELS == (32, 48, 64, 128, 256)
    before = fused_ds_tcn.launches
    with pytest.raises(ValueError, match="C in"):
        fused_ds_tcn(torch.zeros((1, 4, 50)).cuda(),
                     torch.zeros((1, 1, 7, 50)).cuda(),
                     torch.zeros((1, 8, 50)).cuda(),
                     torch.zeros((1, 50)).cuda(),
                     torch.zeros((1, 50, 50)).cuda(),
                     torch.zeros((1, 50)).cuda(), (1,), 8)
    assert fused_ds_tcn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("c", [48, 64, 256])
@pytest.mark.parametrize("b,t,forced", [
    (16, 198, None), (16, 8, None), (3, 7, {"cluster": 8}),
    (5, 40, {"cluster": 3}), (16, 198, {"window": "staged"}),
    (16, 198, {"window": "taps", "nbuf": 1, "rows_per_thread": 2}),
    (16, 8, {"splits": 1}),
    (16, 198, {"cluster": 4, "spread": True}), (1, 2048, "eight layers"),
])
def test_fused_ds_tcn_plans_match_plain(c, b, t, forced):
    """The DS-TCN layer on every plan of the cluster kernel: the wrapper's
    at the main shapes, clusters of 3 and 8 (blocks without frames), the
    layer inputs in L2 (a staged window or each tap's rows), the depth
    split or not, spread clusters, and 8 layers of dilations 1-128
    (pad_max 896: the taps window at C = 64 and 256) over 2048 frames.
    Output and new cache 1e-4 abs + 1e-4 rel, bitwise equal from launch
    to launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops import fused_mdtc as fm
    from wekws_tpu_torch.ops import fused_tcn as ft
    from wekws_tpu_torch.tools.time_serving_kernels import forced_plan

    dil = (tuple(2 ** i for i in range(8)) if forced == "eight layers"
           else (1, 2, 4, 8))
    n, pad = len(dil), 7 * max(dil)
    g = torch.Generator().manual_seed(b * t + c)
    w = _ds_tcn_weights(g, n, 8, c)
    x = torch.randn((b, t, c), generator=g).cuda()
    cache = torch.randn((n, b, pad, c), generator=g).cuda()
    if isinstance(forced, dict):
        fixed = dict(forced)
        cluster = fixed.pop("cluster", fm.mdtc_plan(
            b, t, c, 8, pad, arch="ds_tcn")["cluster"])
        plan = forced_plan(t, c, 8, pad, cluster, fixed.pop("spread", False),
                           "ds_tcn", **fixed)
        got = ft._launch(x, cache, w, dil, 8, plan)
        again = ft._launch(x, cache, w, dil, 8, plan)
    else:
        got = ft.fused_ds_tcn(x, cache, *w, dil, 8)
        again = ft.fused_ds_tcn(x, cache, *w, dil, 8)
    want = ft.fused_ds_tcn_plain(x, cache, *w, dil, 8)
    for a, b_, c_ in zip(got, want, again):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-4)
        assert torch.equal(a, c_)


def _fsmn_weights(g, n_layers, ld, pd, lo, ro):
    return [(torch.randn(shape, generator=g) * scale).cuda()
            for shape, scale in (((n_layers, ld, pd), ld ** -0.5),
                                 ((n_layers, lo, pd), 0.3),
                                 ((n_layers, max(ro, 1), pd), 0.3),
                                 ((n_layers, pd, ld), pd ** -0.5),
                                 ((n_layers, ld), 0.1))]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 11, 70, 130])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_fsmn_kernel_matches_plain(b, t):
    """The recipe's ragged widths (250, 128, P = 11) over five layers,
    ``rorder`` 0, and strides 2 at small widths; T below P and equal to
    it, one tile (the chunk's y gathered through distributed shared
    memory), partial and whole 32-row tiles: output and new cache 1e-4
    abs + 1e-4 rel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_fsmn import (
        fused_fsmn_layers,
        fused_fsmn_layers_plain,
    )

    g = torch.Generator().manual_seed(10 * t + b)
    for ld, pd, lo, ro, ls, rs, n_layers in (
            (250, 128, 10, 2, 1, 1, 5), (250, 128, 10, 0, 1, 1, 3),
            (40, 16, 5, 2, 2, 2, 3), (140, 70, 3, 1, 2, 1, 3)):
        pad = (lo - 1) * ls + ro * rs
        w = _fsmn_weights(g, n_layers, ld, pd, lo, ro)
        x = torch.randn((b, t, ld), generator=g).cuda()
        cache = torch.randn((n_layers, b, pad, pd), generator=g).cuda()
        before = fused_fsmn_layers.launches
        got_y, got_c = fused_fsmn_layers(x, cache, *w, lo, ro, ls, rs)
        assert fused_fsmn_layers.launches == before + 1
        want_y, want_c = fused_fsmn_layers_plain(x, cache, *w, lo, ro, ls, rs)
        torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("t", [10, 66])
def test_fused_fsmn_packed_weights_and_cluster_sizes(t, cluster,
                                                     monkeypatch):
    """Weights packed once (as build_fused_forward does) and packed by
    the wrapper give the plain version's output and cache, with clusters
    of 8 blocks and of 16 (non-portable), at the widest widths the
    kernel takes and at the recipe's; the kernel's shared memory is the
    Python mirror's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops import fused_fsmn as ff

    monkeypatch.setattr(ff, "CLUSTER", cluster)
    lib = cuda_build.load("fused_fsmn")
    g = torch.Generator().manual_seed(t)
    for ld, pd in ((250, 128), (256, 256)):
        w = _fsmn_weights(g, 4, ld, pd, 10, 2)
        x = torch.randn((3, t, ld), generator=g).cuda()
        cache = torch.randn((4, 3, 11, pd), generator=g).cuda()
        want = ff.fused_fsmn_layers_plain(x, cache, *w, 10, 2)
        for packed in (None, ff.pack_fsmn_weights(w[0], w[3])):
            got = ff.fused_fsmn_layers(x, cache, *w, 10, 2, packed=packed)
            torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)
        assert lib.fused_fsmn_smem_bytes(ld, pd, 10, 2, 1, 1, cluster) == \
            ff.fused_fsmn_smem_bytes(ld, pd, 10, 2, 1, 1, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"num_mel_bins": 40}, {"num_mel_bins": 80},
    {"feature_type": "mfcc", "num_mel_bins": 40, "num_ceps": 13},
    {"num_mel_bins": 23, "use_power": False, "use_log_fbank": False},
    {"num_mel_bins": 40, "sample_rate": 8000},
], ids=["fbank40", "fbank80", "mfcc13", "magnitude", "8k"])
@pytest.mark.parametrize("b,n", [(1, 400), (5, 20800), (3, 5519)])
def test_fused_fbank_kernel_matches_plain(kw, b, n):
    """One frame, whole and ragged 32-frame tiles (5 x 128 and 3 x 32
    frames).  Log features 1e-3 abs + 1e-4 rel (fp32 sums over 400 and
    257 terms in another order, then a log); magnitudes 1e-4 of the
    largest.  In-kernel dither: same seed bitwise equal, other seed
    differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.frontend.features import FeatureExtractor
    from wekws_tpu_torch.frontend.kaldi import FrontendConfig
    from wekws_tpu_torch.ops.fused_frontend import fused_fbank

    g = torch.Generator().manual_seed(n + b)
    cfg = FrontendConfig(dither=1.0, dither_mode="frame", **kw)
    n = n * cfg.sample_rate // 16000
    waves = (torch.randn((b, n), generator=g) * 1000).cuda()
    fused, plain = FeatureExtractor(cfg, use_fused=True), FeatureExtractor(cfg)
    before = fused_fbank.launches
    got, _ = fused(waves)
    assert fused_fbank.launches == before + 1
    want, _ = plain(waves)
    if cfg.use_log_fbank:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    gen = torch.Generator(device="cuda")
    outs = []
    for seed in (1, 1, 2):
        gen.manual_seed(seed)
        outs.append(fused(waves, generator=gen)[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], got) and bool(torch.isfinite(outs[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {}, {"frame_length_ms": 25.0625}, {"sample_rate": 8000},
    {"frame_length_ms": 64.0}, {"frame_length_ms": 100.0},
], ids=["n_fft512", "odd_frame", "n_fft256", "n_fft1024", "n_fft2048"])
def test_fused_fbank_fft_and_dense_plans_agree(kw):
    """With dither on and one seed both plans add bitwise the same noise
    (Philox keyed by position): the FFT plan holds the dense-DFT plan
    within the log-mel bound, at every FFT size the plan takes (where
    the dense plan fits a block) and an odd frame; without dither it
    holds the three-matmul extractor.  Given the folded operator alone,
    the wrapper runs the dense plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.frontend.features import FeatureExtractor
    from wekws_tpu_torch.frontend.kaldi import EPSILON, FrontendConfig
    from wekws_tpu_torch.ops import fused_frontend as ff

    cfg = FrontendConfig(dither=1.0, dither_mode="frame", **kw)
    fe = FeatureExtractor(cfg, use_fused=True)
    assert ff.fbank_plan(cfg.padded_window_size) == "fft"
    g = torch.Generator().manual_seed(7)
    waves = (torch.randn((3, 9000), generator=g) * 1000).cuda()
    mats = fe._mats(waves.device)
    seed = torch.tensor([99], dtype=torch.int64, device="cuda")

    def run(plan):
        return ff.fused_fbank(
            waves, mats["analysis"], mats["mel_t"], None,
            frame_length=cfg.frame_length, frame_shift=cfg.frame_shift,
            dither=1.0, seed=seed, epsilon=EPSILON,
            **(fe.fft_operands(mats) if plan == "fft" else {}))

    before = ff.fused_fbank.launches
    fft = run("fft")
    assert ff.fused_fbank.launches == before + 1
    assert torch.equal(run("fft"), fft)
    nbin = cfg.padded_window_size // 2 + 1
    dense_smem = 4 * (32 * (cfg.frame_length + 3) + 32 * nbin + 32 * 40)
    if dense_smem <= 232448:  # else the dense plan raises (n_fft 2048)
        torch.testing.assert_close(fft, run("dense"), atol=1e-3, rtol=1e-4)
    clean, _ = fe(waves)
    torch.testing.assert_close(clean, FeatureExtractor(cfg)(waves)[0],
                               atol=1e-3, rtol=1e-4)


_FLAGSHIP_DIL = (1,) + (1, 2, 4, 8) * 4
_LONG_DIL = (1, 1, 2, 4, 64)  # pad_max 256 at K=5


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,dil,forced", [
    (16, 198, 64, _FLAGSHIP_DIL, None), (16, 8, 64, _FLAGSHIP_DIL, None),
    (1, 1, 64, _FLAGSHIP_DIL, None), (16, 7, 32, _FLAGSHIP_DIL, None),
    (2, 2048, 64, _FLAGSHIP_DIL, None), (2, 2048, 128, _FLAGSHIP_DIL, None),
    (64, 198, 128, _FLAGSHIP_DIL, None),
    (5, 40, 64, _FLAGSHIP_DIL, {"cluster": 3}),
    (3, 7, 64, _FLAGSHIP_DIL, {"cluster": 8}),
    (16, 198, 64, _FLAGSHIP_DIL, {"window": "staged"}),
    (16, 198, 64, _FLAGSHIP_DIL, {"window": "taps"}),
    (16, 8, 64, _FLAGSHIP_DIL, {"splits": 1}),
    (16, 198, 64, _FLAGSHIP_DIL, {"cluster": 4, "spread": True}),
    (2, 300, 128, _LONG_DIL, None), (16, 8, 128, _LONG_DIL, None),
    (2, 300, 64, _LONG_DIL, None),
])
def test_fused_mdtc_plans_match_plain(b, t, c, dil, forced):
    """Every plan of the cluster kernel against the plain version: at the
    flagship's depth (17 layers, K=5, dilations up to 8) one frame,
    chunks shorter than the halo, long utterances (the windows in shared
    memory at C=64, each sub-tile's window staged at C=128), clusters of
    3 and 8 (blocks without frames), the depth split or not, the layer
    inputs in L2 with a staged window or each tap's rows; a halo of 256
    rows (each tap's rows at C=128, a halo over several blocks at C=64).
    Output
    and new cache 1e-4 abs + 1e-4 rel, bitwise equal from launch to
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops import fused_mdtc as fm
    from wekws_tpu_torch.tools.time_serving_kernels import forced_plan

    g = torch.Generator().manual_seed(b * t + c)
    n, pad = len(dil), 4 * max(dil)
    w = [(torch.randn(s, generator=g) * sc).cuda() for s, sc in (
        ((n, 5, c), 0.3), ((n, c), 0.1), ((n, c, c), c ** -0.5),
        ((n, c), 0.1), ((n, c, c), c ** -0.5), ((n, c), 0.1))]
    x = torch.randn((b, t, c), generator=g).cuda()
    cache = torch.randn((n, b, pad, c), generator=g).cuda()
    if forced is None:
        got = fm.fused_mdtc_forward(x, *w, dil, 5, 4)
        got_y, got_c = fm.fused_mdtc_stream(x, cache, *w, dil, 5, 4)
        again = fm.fused_mdtc_forward(x, *w, dil, 5, 4)
    else:
        fixed = dict(forced)
        cluster = fixed.pop("cluster", fm.mdtc_plan(b, t, c, 5, pad)["cluster"])
        plan = forced_plan(t, c, 5, pad, cluster, fixed.pop("spread", False),
                           **fixed)
        got = fm._launch(x, None, w, dil, 5, 4, plan)[0]
        got_y, got_c = fm._launch(x, cache, w, dil, 5, 4, plan)
        again = fm._launch(x, None, w, dil, 5, 4, plan)[0]
    want = fm.fused_mdtc_forward_plain(x, *w, dil, 5, 4)
    want_y, want_c = fm.fused_mdtc_stream_plain(x, cache, *w, dil, 5, 4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_serving_kernels_shared_memory_mirrors():
    """The wrappers' mirrors of the two kernels' shared memory and block
    sizes equal what the compiled libraries compute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops import cuda_build
    from wekws_tpu_torch.ops import fused_frontend as ff
    from wekws_tpu_torch.ops import fused_mdtc as fm

    lib = cuda_build.load("fused_frontend")
    for n_fft in ff.FFT_SIZES:
        assert lib.fused_fbank_fft_frames(n_fft) == ff.fft_frames(n_fft)
        assert lib.fused_fbank_fft_smem_bytes(
            n_fft, min(400, n_fft), 492, 40) == ff.fft_smem_bytes(
                n_fft, min(400, n_fft), 492, 40)
    assert lib.fused_fbank_fft_frames(400) == 0
    lib = cuda_build.load("fused_mdtc")
    for t, c, pad, n, rpt, splits, window, nbuf in (
            (198, 64, 32, 8, 2, 1, "smem", 2), (8, 64, 32, 1, 1, 2, "smem", 2),
            (2048, 128, 32, 8, 4, 1, "staged", 1),
            (198, 32, 32, 6, 4, 1, "smem", 2),
            (300, 128, 256, 8, 3, 1, "taps", 1)):
        assert lib.fused_mdtc_smem_bytes(
            t, c, 5, pad, n, rpt, splits, fm.WINDOWS.index(window),
            nbuf) == fm.mdtc_smem_bytes(t, c, 5, pad, n, rpt, splits, window,
                                        nbuf)
    # the DS-TCN layer's: one resident W, or (C = 256) W in slices
    for t, c, pad, n, rpt, splits, window, nbuf in (
            (198, 64, 56, 6, 3, 1, "smem", 2), (8, 64, 56, 1, 1, 2, "smem", 2),
            (198, 48, 56, 7, 2, 1, "smem", 2), (8, 48, 56, 1, 1, 2, "smem", 2),
            (198, 256, 56, 7, 4, 1, "staged", 2),
            (8, 256, 56, 1, 2, 1, "smem", 2),
            (2048, 256, 896, 8, 4, 1, "taps", 1)):
        assert lib.fused_ds_tcn_smem_bytes(
            t, c, 8, pad, n, rpt, splits, fm.WINDOWS.index(window),
            nbuf) == fm.mdtc_smem_bytes(t, c, 8, pad, n, rpt, splits, window,
                                        nbuf, "ds_tcn")
