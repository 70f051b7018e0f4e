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
    at C=128, and B x T = 210 frames, which no tile of F3, B2 or B3 (64
    or 32 rows over the flattened frames) divides.  Their tiles span
    utterances: at T=70 and T=130 a tile holds the end of one and the
    start of the next, at T=8 and T=20 a tile holds all three, shorter
    than dilation 8's halo of 32 frames; F3's conv must not reach into
    the earlier utterance.  B3 hands its ds0 to B4; every pass is
    bitwise equal when launched twice."""
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
        (64, 5),)
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


@pytest.mark.cuda
def test_fused_train_f3_without_its_window():
    """At C=128 a halo of (5-1) x 16 = 64 frames leaves no room for
    F3's staged window of x beside its weights and tiles, so it reads
    its taps from device memory: outputs within 1e-4 abs + 1e-4 rel of
    the plain version's, sums within 1e-3 of the largest, bitwise equal
    when launched twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        PASSES,
        SMEM_LIMIT,
        compare_pass,
        f3_window_bytes,
        seeded_block_inputs,
        tile_smem_bytes,
        trace_pass_inputs,
    )

    assert tile_smem_bytes("f3", 128, 64) + f3_window_bytes(128, 64) \
        > SMEM_LIMIT
    g = torch.Generator().manual_seed(16)
    p, x, dy = seeded_block_inputs(g, 3, 130, 128, 5, "cuda")
    args = trace_pass_inputs(x, p, dy, 16)["f3"]
    got = PASSES["f3"](*args)
    again = PASSES["f3"](*args)
    torch.cuda.synchronize()
    compare_pass("f3", got, PASSES["f3"].plain(*args))
    for a, b in zip(got, again):
        assert torch.equal(a, b), "f3 is not reproducible"


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
@pytest.mark.parametrize("t", [1, 8, 70, 130])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_ds_tcn_kernel_matches_plain(b, t):
    """A single frame, a streaming chunk shorter than pad_max, partial
    and whole 64-row tiles, from a random carried cache: output and new
    cache 1e-4 abs + 1e-4 rel (fp32, another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_tcn import fused_ds_tcn, fused_ds_tcn_plain

    g = torch.Generator().manual_seed(10 * t + b)
    for c, k, dil in ((64, 8, (1, 2, 4, 8)), (32, 5, (1, 2))):
        n_layers, pad = len(dil), (k - 1) * max(dil)
        w = [(torch.randn(shape, generator=g) * scale).cuda()
             for shape, scale in (((n_layers, k, c), 0.3), ((n_layers, c), 0.1),
                                  ((n_layers, c, c), c ** -0.5),
                                  ((n_layers, c), 0.1))]
        x = torch.randn((b, t, c), generator=g).cuda()
        cache = torch.randn((n_layers, b, pad, c), generator=g).cuda()
        before = fused_ds_tcn.launches
        got_y, got_c = fused_ds_tcn(x, cache, *w, dil, k)
        assert fused_ds_tcn.launches == before + 1
        want_y, want_c = fused_ds_tcn_plain(x, cache, *w, dil, k)
        torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="C in"):
        fused_ds_tcn(torch.zeros((1, 4, 48)).cuda(),
                     torch.zeros((1, 1, 7, 48)).cuda(),
                     torch.zeros((1, 8, 48)).cuda(),
                     torch.zeros((1, 48)).cuda(),
                     torch.zeros((1, 48, 48)).cuda(),
                     torch.zeros((1, 48)).cuda(), (1,), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 70, 130])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_fsmn_kernel_matches_plain(b, t):
    """The recipe's ragged widths (250, 128, P = 11), ``rorder`` 0, and
    strides 2 at small widths; T below P, partial and whole 32-row
    tiles: output and new cache 1e-4 abs + 1e-4 rel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wekws_tpu_torch.ops.fused_fsmn import (
        fused_fsmn_layers,
        fused_fsmn_layers_plain,
    )

    g = torch.Generator().manual_seed(10 * t + b)
    for ld, pd, lo, ro, ls, rs in ((250, 128, 10, 2, 1, 1),
                                   (250, 128, 10, 0, 1, 1),
                                   (40, 16, 5, 2, 2, 2), (140, 70, 3, 1, 2, 1)):
        n_layers, pad = 3, (lo - 1) * ls + ro * rs
        w = [(torch.randn(shape, generator=g) * scale).cuda()
             for shape, scale in (((n_layers, ld, pd), ld ** -0.5),
                                  ((n_layers, lo, pd), 0.3),
                                  ((n_layers, max(ro, 1), pd), 0.3),
                                  ((n_layers, pd, ld), pd ** -0.5),
                                  ((n_layers, ld), 0.1))]
        x = torch.randn((b, t, ld), generator=g).cuda()
        cache = torch.randn((n_layers, b, pad, pd), generator=g).cuda()
        before = fused_fsmn_layers.launches
        got_y, got_c = fused_fsmn_layers(x, cache, *w, lo, ro, ls, rs)
        assert fused_fsmn_layers.launches == before + 1
        want_y, want_c = fused_fsmn_layers_plain(x, cache, *w, lo, ro, ls, rs)
        torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_c, want_c, atol=1e-4, rtol=1e-4)


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
