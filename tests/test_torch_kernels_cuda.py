"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; skips on a host without a CUDA device. On the card host
(which has no JAX, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Covers geometries beyond the served ones: ragged key/query tails (HW not a
multiple of the 64-row tiles), W != H, every dvh the kernel takes, and
more heads than fit one grid row of blocks."""

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops.attention import pack_query
from chexpert_tpu_torch.ops.fused_attention import (
    NAME,
    rel_attention_fwd,
    rel_attention_fwd_plain,
)

pytestmark = pytest.mark.cuda

# same reasons as chip_smoke.py's TOL: f32 reorder; bf16 output rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, nh, H, W, dvh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    dkh, hw = 20, H * W
    q = torch.randn(B, nh, hw, dkh, generator=g) * dkh ** -0.5
    k = torch.randn(B * nh, hw, dkh, generator=g)
    v = torch.randn(B * nh, hw, dvh, generator=g)
    rel_w = torch.randn(dkh, 2 * W - 1, generator=g)
    rel_h = torch.randn(dkh, 2 * H - 1, generator=g)
    qr = pack_query(q, rel_w, rel_h, H, W).reshape(B * nh, hw, -1)
    return [t.to("cuda", dtype).contiguous() for t in (qr, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nh,H,W,dvh", [
    (1, 1, 1, 1, 1), (1, 2, 1, 3, 2), (2, 2, 6, 5, 1), (2, 2, 6, 5, 8), (1, 3, 7, 11, 4),
    (2, 8, 10, 10, 6), (1, 8, 20, 20, 3), (1, 8, 40, 40, 1), (1, 2, 33, 17, 5),
    (1, 1, 64, 64, 2),
])
def test_kernel_matches_plain(cuda, B, nh, H, W, dvh, dtype):
    qr, k, v = _inputs(B, nh, H, W, dvh, dtype)
    kernels.reset_launch_counts()
    out, lse = rel_attention_fwd(qr, k, v, H, W, 20)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[NAME] == 1
    out_p, lse_p = rel_attention_fwd_plain(qr, k, v, H, W, 20)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - out_p.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_p).abs().max().item() <= TOL[dtype]


def test_kernel_rejects_what_it_does_not_take(cuda):
    qr, k, v = _inputs(1, 2, 6, 5, 3, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        rel_attention_fwd(qr.half(), k.half(), v.half(), 6, 5, 20)
    with pytest.raises(ValueError, match="contiguous"):
        rel_attention_fwd(qr.transpose(0, 1).contiguous().transpose(0, 1), k, v, 6, 5, 20)
    with pytest.raises(ValueError, match="dvh"):
        rel_attention_fwd(qr, k, torch.zeros(2, 30, 9, device="cuda"), 6, 5, 20)
