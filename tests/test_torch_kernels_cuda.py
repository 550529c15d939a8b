"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; skips on a host without a CUDA device. On the card host
(which has no JAX, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Covers geometries beyond the served and trained ones: ragged key/query
tails (HW not a multiple of the 64/128-row tiles), W != H, every dvh the
kernels take, and more heads than fit one grid row of blocks. B1 (forward)
and B2 (backward, two passes) run at the same geometries. B3 / B4 (the
depthwise conv forward / backward) run at the ten stride-1 geometries of
efficientnet-b4 at 380x380 and at ragged ones (odd H and W, H != W, C not a
multiple of 32, maps smaller than one block's items, every k the kernels
are instantiated for). B5 / B6 (the heads-in-lanes attention forward and the
backward's three passes) run at B1's geometries over the packed operand, at
the model's slot stride, the tight one and 64, with and without relative
logits."""

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops.attention import pack_query
from chexpert_tpu_torch.ops.depthwise import BWD as DW_BWD
from chexpert_tpu_torch.ops.depthwise import FWD as DW_FWD
from chexpert_tpu_torch.ops.depthwise import (
    depthwise_bwd,
    depthwise_bwd_plain,
    depthwise_conv2d,
    depthwise_fwd,
    depthwise_fwd_plain,
)
from chexpert_tpu_torch.ops.fused_attention import (
    BWD_DKDV,
    BWD_DQ,
    NAME,
    RelAttention,
    rel_attention_bwd,
    rel_attention_bwd_plain,
    rel_attention_fwd,
    rel_attention_fwd_plain,
)

from chexpert_tpu_torch.ops.hil_attention import (
    BWD_PASSES,
    FWD,
    HilAttention,
    hil_attention_bwd,
    hil_attention_bwd_plain,
    hil_attention_fwd,
    hil_attention_fwd_plain,
    hil_rel_operand,
    hil_slot,
)

pytestmark = pytest.mark.cuda

# same reasons as chip_smoke.py's TOL: f32 reorder; bf16 output rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# B2, relative to max(1, max |plain|) per output: f32, the same f32 algorithm
# summed in another order over up to 4096 keys; bf16, both sides round their
# f32 result to bf16, one ulp of which is at most 2^-7 of the largest value
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
GEOMETRIES = [
    (1, 1, 1, 1, 1), (1, 2, 1, 3, 2), (2, 2, 6, 5, 1), (2, 2, 6, 5, 8), (1, 3, 7, 11, 4),
    (2, 8, 10, 10, 6), (1, 8, 20, 20, 3), (1, 8, 40, 40, 1), (1, 2, 33, 17, 5),
    (1, 1, 64, 64, 2),
]

# B3 / B4, max |kernel - plain| / max |plain| per output: y and dx, f32 the
# same f32 sums in another order, bf16 one output rounding (2^-8 of the
# largest value); dw, an f32 sum over up to B*H*W terms in both dtypes
DW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DW_W_TOL = 1e-4
DW_GEOMETRIES = [  # (B, H, W, C, k)
    (2, 190, 190, 48, 3), (2, 190, 190, 24, 3), (2, 95, 95, 192, 3), (2, 48, 48, 336, 5),
    (2, 24, 24, 672, 3), (2, 24, 24, 672, 5), (2, 24, 24, 960, 5), (2, 12, 12, 1632, 5),
    (2, 12, 12, 1632, 3), (2, 12, 12, 2688, 3),
    (1, 7, 9, 37, 3), (3, 5, 3, 33, 5), (1, 1, 1, 5, 3), (2, 13, 11, 70, 7), (1, 6, 6, 3, 9),
    (2, 10, 10, 16, 1),
]


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
@pytest.mark.parametrize("B,nh,H,W,dvh", GEOMETRIES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nh,H,W,dvh", GEOMETRIES)
def test_bwd_kernel_matches_plain(cuda, B, nh, H, W, dvh, dtype):
    qr, k, v = _inputs(B, nh, H, W, dvh, dtype)
    out, lse = rel_attention_fwd(qr, k, v, H, W, 20)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
    kernels.reset_launch_counts()
    got = rel_attention_bwd(qr, k, v, out, lse, dout, H, W, 20)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {BWD_DKDV: 1, BWD_DQ: 1}
    want = rel_attention_bwd_plain(qr, k, v, out, lse, dout, H, W, 20)
    for name, g, w, op in zip(("dqr", "dk", "dv"), got, want, (qr, k, v)):
        assert g.dtype == op.dtype and g.shape == op.shape, name
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (name, err, scale)


def test_rel_attention_autograd_launches_both_kernels(cuda):
    """RelAttention.apply under autograd: B1 forward, B2 backward, and the
    bare forward wrapper refuses grad-requiring CUDA operands."""
    qr, k, v = _inputs(1, 2, 6, 5, 3, torch.float32)
    qr.requires_grad_()
    with pytest.raises(RuntimeError, match="RelAttention"):
        rel_attention_fwd(qr, k, v, 6, 5, 20)
    kernels.reset_launch_counts()
    RelAttention.apply(qr, k, v, 6, 5, 20).sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {NAME: 1, BWD_DKDV: 1, BWD_DQ: 1}
    assert qr.grad is not None and torch.isfinite(qr.grad).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    qr, k, v = _inputs(1, 2, 6, 5, 3, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        rel_attention_fwd(qr.half(), k.half(), v.half(), 6, 5, 20)
    with pytest.raises(ValueError, match="contiguous"):
        rel_attention_fwd(qr.transpose(0, 1).contiguous().transpose(0, 1), k, v, 6, 5, 20)
    with pytest.raises(ValueError, match="dvh"):
        rel_attention_fwd(qr, k, torch.zeros(2, 30, 9, device="cuda"), 6, 5, 20)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _dw_inputs(B, H, W, C, k, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, C, H, W, generator=g).to("cuda", dtype)
    w = (torch.randn(C, 1, k, k, generator=g) * 0.2).to("cuda")
    gy = torch.randn(B, C, H, W, generator=g).to("cuda", dtype)
    return x, w, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,k", DW_GEOMETRIES)
def test_depthwise_kernels_match_plain(cuda, B, H, W, C, k, dtype):
    x, w, gy = _dw_inputs(B, H, W, C, k, dtype)
    kernels.reset_launch_counts()
    y = depthwise_fwd(x, w)
    dx, dw = depthwise_bwd(x, w, gy)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {DW_FWD: 1, DW_BWD: 1}
    y_p = depthwise_fwd_plain(x, w)
    dx_p, dw_p = depthwise_bwd_plain(x, w, gy)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32 and dw.shape == w.shape
    assert _rel(y, y_p) <= DW_TOL[dtype], _rel(y, y_p)
    assert _rel(dx, dx_p) <= DW_TOL[dtype], _rel(dx, dx_p)
    assert _rel(dw, dw_p) <= DW_W_TOL, _rel(dw, dw_p)


def test_depthwise_autograd_launches_both_kernels(cuda):
    """depthwise_conv2d under bf16 autocast: B3 forward, B4 backward, the
    weight gradient f32; the library route launches neither; the bare
    forward wrapper refuses grad-requiring operands."""
    x, w, _ = _dw_inputs(2, 24, 24, 64, 5, torch.float32)
    x.requires_grad_()
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="DepthwiseConv2d"):
        depthwise_fwd(x, w)
    kernels.reset_launch_counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = depthwise_conv2d(x, w, 1)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {DW_FWD: 1, DW_BWD: 1}
    assert w.grad.dtype == torch.float32 and torch.isfinite(w.grad).all()
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
    kernels.reset_launch_counts()
    depthwise_conv2d(x, w, 1, impl="library").sum().backward()
    depthwise_conv2d(x, w, 2).sum().backward()
    assert kernels.launch_counts() == {}


def test_depthwise_kernels_reject_what_they_do_not_take(cuda):
    x, w, gy = _dw_inputs(1, 8, 8, 4, 3, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        depthwise_fwd(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_fwd(x.to(memory_format=torch.channels_last), w)
    with pytest.raises(ValueError, match="instantiated"):
        depthwise_fwd(x, torch.zeros(4, 1, 11, 11, device="cuda"))
    with pytest.raises(ValueError, match="must match"):
        depthwise_bwd(x, w, gy.bfloat16())


# --- B5 / B6: heads-in-lanes attention ----------------------------------------

def _hil_inputs(B, nh, H, W, dvh, dtype, slot, relative=True, seed=0):
    """(P0, Rw, Rh): the packed operand with zero pad lanes and the f32 block
    operands of seeded relative embeddings (None without them)."""
    g = torch.Generator().manual_seed(seed)
    dkh, hw = 20, H * W
    q = torch.randn(B, hw, nh, dkh, generator=g) * dkh ** -0.5
    k = torch.randn(B, hw, nh, dkh, generator=g)
    v = torch.randn(B, hw, nh, dvh, generator=g)
    pad = torch.zeros(B, hw, nh, slot - 2 * dkh - dvh)
    P0 = torch.cat([q, k, v, pad], -1).reshape(B, hw, nh * slot).to("cuda", dtype)
    if not relative:
        return P0, None, None
    rel_w = torch.randn(dkh, 2 * W - 1, generator=g).to("cuda")
    rel_h = torch.randn(dkh, 2 * H - 1, generator=g).to("cuda")
    return P0, hil_rel_operand(rel_w, W).contiguous(), hil_rel_operand(rel_h, H).contiguous()


def _slot(mode, dvh):
    return {"model": hil_slot(20, dvh), "tight": 40 + dvh, "64": 64}[mode]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slot_mode,relative", [("model", True), ("tight", True), ("64", True),
                                                ("model", False)])
@pytest.mark.parametrize("B,nh,H,W,dvh", GEOMETRIES)
def test_hil_kernels_match_plain(cuda, B, nh, H, W, dvh, slot_mode, relative, dtype):
    slot = _slot(slot_mode, dvh)
    P0, Rw, Rh = _hil_inputs(B, nh, H, W, dvh, dtype, slot, relative)
    kernels.reset_launch_counts()
    out, lse = hil_attention_fwd(P0, Rw, Rh, H, W, 20, dvh, slot)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {FWD: 1}
    out_p, lse_p = hil_attention_fwd_plain(P0, Rw, Rh, H, W, 20, dvh, slot)
    assert out.dtype == dtype and out.shape == (B, H * W, nh * dvh)
    assert lse.dtype == torch.float32 and lse.shape == (B, nh, H * W)
    assert (out.float() - out_p.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_p).abs().max().item() <= TOL[dtype]

    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
    kernels.reset_launch_counts()
    got = hil_attention_bwd(P0, Rw, Rh, out, lse, dout, H, W, 20, dvh, slot)
    torch.cuda.synchronize()
    passes = BWD_PASSES if relative else BWD_PASSES[:2]
    assert kernels.launch_counts() == {p: 1 for p in passes}
    want = hil_attention_bwd_plain(P0, Rw, Rh, out, lse, dout, H, W, 20, dvh, slot)
    dP = got[0]
    assert dP.dtype == dtype and dP.shape == P0.shape
    pads = dP.view(B, H * W, nh, slot)[..., 40 + dvh:]
    assert torch.count_nonzero(pads) == 0  # every pad lane written, as zero
    if not relative:
        assert got[1] is None and got[2] is None
    for name, g, w in zip(("dP", "dRw", "dRh"), got, want):
        if w is None:
            continue
        assert g.shape == w.shape and torch.isfinite(g.float()).all(), name
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (name, err, scale)


def test_hil_attention_autograd_launches_every_kernel(cuda):
    """HilAttention.apply under autograd: B5 forward, B6's three passes, the
    operand gradients finite; the bare forward wrapper refuses grad-requiring
    CUDA operands."""
    P0, Rw, Rh = _hil_inputs(1, 2, 6, 5, 3, torch.float32, 48)
    leaves = [t.requires_grad_() for t in (P0, Rw, Rh)]
    with pytest.raises(RuntimeError, match="HilAttention"):
        hil_attention_fwd(*leaves, 6, 5, 20, 3, 48)
    kernels.reset_launch_counts()
    HilAttention.apply(*leaves, 6, 5, 20, 3, 48).sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {FWD: 1, **{p: 1 for p in BWD_PASSES}}
    for t in leaves:
        assert t.grad is not None and t.grad.shape == t.shape and torch.isfinite(t.grad).all()


def test_hil_kernels_reject_what_they_do_not_take(cuda):
    P0, Rw, Rh = _hil_inputs(2, 2, 6, 5, 3, torch.float32, 48)
    with pytest.raises(ValueError, match="dtype"):
        hil_attention_fwd(P0.half(), Rw, Rh, 6, 5, 20, 3, 48)
    with pytest.raises(ValueError, match="float32"):
        hil_attention_fwd(P0, Rw.bfloat16(), Rh.bfloat16(), 6, 5, 20, 3, 48)
    with pytest.raises(ValueError, match="contiguous"):
        hil_attention_fwd(P0.transpose(0, 1).contiguous().transpose(0, 1), Rw, Rh,
                          6, 5, 20, 3, 48)
    wide = torch.zeros(1, 30, 2 * 32, device="cuda")  # dkh 8: not instantiated
    with pytest.raises(ValueError, match="dkh"):
        hil_attention_fwd(wide, None, None, 6, 5, 8, 3, 32)
