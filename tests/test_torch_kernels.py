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
