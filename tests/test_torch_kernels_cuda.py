"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; skips on a host without a CUDA device. On the card host
(which has no JAX, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Covers geometries beyond the served and trained ones: ragged key/query
tails (HW not a multiple of the 64/128-row tiles nor of the tensor-core
kernels' 16-row fragments, maps smaller than one tile), W != H, every dvh
the kernels take, and more heads than fit one grid row of blocks. B1 (forward)
and B2 (backward, two passes) run at the same geometries. B3 / B4 (the
depthwise conv forward / backward) run at the ten stride-1 geometries of
efficientnet-b4 at 380x380 and at ragged ones (odd H and W, H != W, C not a
multiple of 32, maps smaller than one tile, C = G +- 1 for the grouped
planes, rows wider than one tile, every k the kernels are instantiated for,
tensors that start off a 16-byte boundary). B5 / B6 (the heads-in-lanes attention forward and the
backward's three passes) run at B1's geometries over the packed operand, at
the model's slot stride, the tight one and 64, with and without relative
logits. The bf16 forwards and backward passes run the tensor-core kernels up
to 64x64 and the CUDA-core kernels past it; the forwards are held at more
ragged maps on both routes (FWD_GEOMETRIES). Every head-width class of
``fused_attention.WIDTH_CLASSES`` is held at the widths the JAX package's
models reach (WIDTHS: dkh 24, 26, 32, 20, 64, 128 with dvh up to 64, ragged
dkh and dvh included) on both layouts and both routes, heads past the
largest class (WIDE_CASES: the chunked kernels of ``csrc/attention_wide.cuh``,
dkh up to 512 and dvh up to 256, ragged widths included) likewise, and widths
below 1 raise ValueError. The CIFAR bench's ``to_device`` whitens its uint8
batch on the card as ``normalize`` does on the host."""

import os

import numpy as np
import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.cli import bench
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
    WIDTH_CLASSES,
    RelAttention,
    on_tensor_cores,
    rel_attention_bwd,
    rel_attention_bwd_plain,
    rel_attention_fwd,
    rel_attention_fwd_plain,
    bwd_pack,
    fwd_pack,
    sm_count,
    wide_bwd_plan,
    wide_fwd_plan,
    width_class,
    width_plan,
)

from chexpert_tpu_torch.ops.hil_attention import (
    BWD_PASSES,
    FWD,
    HilAttention,
    drel_plan,
    hil_attention_bwd,
    hil_attention_bwd_drel,
    hil_attention_bwd_drel_plain,
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
    # edges of the tensor-core tiles of B2 / B6 (16-row fragments, 64-row tiles):
    # HW not a multiple of 16, smaller than one tile, exactly one tile, dvh 1
    # and 8, W + H past the one-hot bin tiles (the CUDA-core kernels in bf16)
    (1, 2, 5, 5, 1), (1, 2, 5, 5, 8), (2, 2, 7, 9, 8), (1, 2, 9, 7, 1), (1, 1, 3, 3, 8),
    (1, 3, 4, 16, 2), (1, 1, 72, 64, 2),
]

# (dkh, dvh) of each width class: the bench's --attn_k 0.3 / 0.33, --attn_nh 4
# and 2 and --attn_v 0.2 heads, a ragged dkh with a ragged dvh, and the widest
WIDTHS = [(24, 8), (26, 12), (32, 16), (20, 16), (64, 32), (128, 64)]
# (B, nh, H, W): a map under one key tile (HW 35, not a multiple of 16), two
# key tiles with a ragged second (81), the bench's 16x16 and 8x8, the largest
# map on the tensor cores (W + H 128: each pass's shared memory at its peak
# for its class), and a map past the tensor-core rule (the CUDA-core kernels
# in bf16)
WIDTH_MAPS = [(1, 2, 5, 7), (2, 3, 9, 9), (1, 2, 16, 16), (2, 2, 8, 8), (1, 1, 64, 64),
              (1, 1, 72, 64)]

# the forwards' key tiles (64 keys) and query tiles (64 rows, 16 per warp):
# a ragged second key tile, 65 keys, two whole tiles, the largest map on the
# tensor cores, the smallest past them, one image row or column
FWD_GEOMETRIES = [
    (2, 3, 9, 9, 7), (1, 2, 13, 5, 3), (1, 1, 16, 8, 8), (1, 2, 64, 64, 1), (1, 1, 65, 64, 4),
    (1, 2, 1, 64, 2), (1, 2, 64, 1, 2),
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
    # shapes the tile plan (csrc/depthwise_common.cuh) treats apart: an odd plane size
    # (95 x 95, plane starts alternate in alignment), 12-wide rows, C = G +- 1 for the
    # grouped planes (G = 28 at 12x12, 7 at 24x24), B = 1, H below one band of a wide
    # map, rows wider than one tile, k = 7 and 9 on larger maps
    (1, 95, 95, 5, 3), (3, 95, 95, 2, 5), (1, 12, 12, 27, 3), (2, 12, 12, 29, 5),
    (1, 12, 12, 57, 3), (2, 24, 24, 8, 5), (1, 24, 24, 6, 3), (1, 3, 190, 4, 3),
    (2, 2, 301, 3, 5), (2, 40, 40, 6, 7), (1, 33, 30, 5, 9), (1, 190, 190, 3, 9),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, nh, H, W, dvh, dtype, seed=0, dkh=20):
    g = torch.Generator().manual_seed(seed)
    hw = H * W
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
    with pytest.raises(ValueError, match="dvh=0"):  # no head width below 1
        rel_attention_fwd(qr, k, torch.zeros(2, 30, 0, device="cuda"), 6, 5, 20)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,k", [(2, 95, 95, 3, 3), (1, 12, 12, 29, 5), (2, 7, 9, 5, 3)])
def test_depthwise_kernels_match_plain_on_misaligned_tensors(cuda, B, H, W, C, k, dtype):
    """Contiguous views that start 1 or 3 elements past a 16-byte boundary:
    every row of the staged tiles sits at another offset than the parent's."""
    x0, w, gy0 = _dw_inputs(B, H, W, C, k, dtype)
    n = x0.numel()
    x = torch.empty(n + 1, dtype=dtype, device="cuda")[1:].view(x0.shape)
    gy = torch.empty(n + 3, dtype=dtype, device="cuda")[3:].view(x0.shape)
    x.copy_(x0)
    gy.copy_(gy0)
    y = depthwise_fwd(x, w)
    dx, dw = depthwise_bwd(x, w, gy)
    torch.cuda.synchronize()
    dx_p, dw_p = depthwise_bwd_plain(x0, w, gy0)
    assert _rel(y, depthwise_fwd_plain(x0, w)) <= DW_TOL[dtype]
    assert _rel(dx, dx_p) <= DW_TOL[dtype]
    assert _rel(dw, dw_p) <= DW_W_TOL


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

def _hil_inputs(B, nh, H, W, dvh, dtype, slot, relative=True, seed=0, dkh=20):
    """(P0, Rw, Rh): the packed operand with zero pad lanes and the f32 block
    operands of seeded relative embeddings (None without them)."""
    g = torch.Generator().manual_seed(seed)
    hw = H * W
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["bn", "hil", "hil-tight"])
@pytest.mark.parametrize("B,nh,H,W,dvh", FWD_GEOMETRIES)
def test_fwd_kernels_match_plain_on_both_routes(cuda, B, nh, H, W, dvh, layout, dtype):
    """B1 and B5 (at the model's slot and the tight one) against their plain
    versions: out and lse within TOL, in bf16 on the tensor cores up to 64x64
    and on the CUDA cores past it, and in f32."""
    kernels.reset_launch_counts()
    if layout == "bn":
        qr, k, v = _inputs(B, nh, H, W, dvh, dtype)
        got = rel_attention_fwd(qr, k, v, H, W, 20)
        want = rel_attention_fwd_plain(qr, k, v, H, W, 20)
    else:
        slot = _slot("model" if layout == "hil" else "tight", dvh)
        P0, Rw, Rh = _hil_inputs(B, nh, H, W, dvh, dtype, slot)
        got = hil_attention_fwd(P0, Rw, Rh, H, W, 20, dvh, slot)
        want = hil_attention_fwd_plain(P0, Rw, Rh, H, W, 20, dvh, slot)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {NAME if layout == "bn" else FWD: 1}
    assert on_tensor_cores(dtype, H, W) == (dtype == torch.bfloat16 and (H, W) != (65, 64))
    out, lse = got
    assert out.dtype == dtype and out.shape == want[0].shape and lse.shape == want[1].shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - want[0].float()).abs().max().item() <= TOL[dtype]
    assert (lse - want[1]).abs().max().item() <= TOL[dtype]


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
    empty = torch.zeros(1, 30, 2 * 264, device="cuda")  # dkh 0: no head width below 1
    with pytest.raises(ValueError, match="dkh=0"):
        hil_attention_fwd(empty, None, None, 6, 5, 0, 3, 264)


def _check_close(name, got, want, tol, scale_by_max):
    assert got.shape == want.shape and torch.isfinite(got.float()).all(), name
    scale = max(1.0, want.float().abs().max().item()) if scale_by_max else 1.0
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (name, err, scale)


def _match_plain(dkh, dvh, B, nh, H, W, layout, dtype, slot=None):
    """B1 / B5 and every backward pass of B2 / B6 at the head (dkh, dvh) and
    map against the plain versions: out and lse within TOL, the gradients
    within BWD_TOL, one launch of each kernel, the pad lanes of dP zero
    (heads-in-lanes at ``slot``, by default ``hil_slot``)."""
    dout_gen = torch.Generator().manual_seed(1)
    kernels.reset_launch_counts()
    if layout == "bn":
        qr, k, v = _inputs(B, nh, H, W, dvh, dtype, dkh=dkh)
        out, lse = rel_attention_fwd(qr, k, v, H, W, dkh)
        want = rel_attention_fwd_plain(qr, k, v, H, W, dkh)
        dout = torch.randn(out.shape, generator=dout_gen).to("cuda", dtype)
        got_b = rel_attention_bwd(qr, k, v, out, lse, dout, H, W, dkh)
        want_b = rel_attention_bwd_plain(qr, k, v, out, lse, dout, H, W, dkh)
        names, launched = ("dqr", "dk", "dv"), {NAME: 1, BWD_DKDV: 1, BWD_DQ: 1}
    else:
        slot = slot or hil_slot(dkh, dvh)
        P0, Rw, Rh = _hil_inputs(B, nh, H, W, dvh, dtype, slot, dkh=dkh)
        geo = (H, W, dkh, dvh, slot)
        out, lse = hil_attention_fwd(P0, Rw, Rh, *geo)
        want = hil_attention_fwd_plain(P0, Rw, Rh, *geo)
        dout = torch.randn(out.shape, generator=dout_gen).to("cuda", dtype)
        got_b = hil_attention_bwd(P0, Rw, Rh, out, lse, dout, *geo)
        want_b = hil_attention_bwd_plain(P0, Rw, Rh, out, lse, dout, *geo)
        names, launched = ("dP", "dRw", "dRh"), {FWD: 1, **{p: 1 for p in BWD_PASSES}}
        pads = got_b[0].view(B, H * W, nh, slot)[..., 2 * dkh + dvh:]
        assert torch.count_nonzero(pads) == 0
    torch.cuda.synchronize()
    assert kernels.launch_counts() == launched
    assert out.dtype == dtype
    _check_close("out", out, want[0], TOL[dtype], False)
    _check_close("lse", lse, want[1], TOL[dtype], False)
    for name, g, w in zip(names, got_b, want_b):
        _check_close(name, g, w, BWD_TOL[dtype], True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("B,nh,H,W", WIDTH_MAPS)
@pytest.mark.parametrize("dkh,dvh", WIDTHS)
def test_kernels_match_plain_at_every_width_class(cuda, dkh, dvh, B, nh, H, W, layout, dtype):
    """B1 / B5 and every backward pass of B2 / B6 at the width (dkh, dvh),
    which the library of its class (width_class) runs, against the plain
    versions: out and lse within TOL, the gradients within BWD_TOL."""
    cls = width_class(dkh, dvh)
    assert dkh <= cls[0] and dvh <= cls[1]
    _match_plain(dkh, dvh, B, nh, H, W, layout, dtype)


# heads past the largest width class, ((dkh, dvh), (B, nh, H, W)): the bench's
# --attn_k 0.5 --attn_v 0.2 --attn_nh 1 heads at their maps, the densenet
# bench's ragged (150, 75), resnet's (512, 256) at 1x1, one chunk past the
# class in each width alone, (256, 128) at 64x64 (the largest map on the
# tensor cores: each wide pass's shared memory at its peak) and a map past the
# tensor-core rule (the CUDA-core kernels in bf16)
WIDE_CASES = [((160, 64), (1, 2, 16, 16)), ((320, 128), (2, 1, 8, 8)),
              ((150, 75), (1, 2, 8, 8)), ((512, 256), (2, 2, 1, 1)),
              ((129, 8), (1, 2, 5, 7)), ((20, 65), (2, 1, 9, 9)),
              ((256, 128), (1, 1, 64, 64)), ((160, 64), (1, 1, 72, 72))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("head,geo", WIDE_CASES, ids=lambda x: "x".join(map(str, x)))
def test_wide_heads_match_plain(cuda, head, geo, layout, dtype):
    """A head past the largest width class runs in its library in chunks
    (width_plan: nk or nv above 1) and matches the plain versions as the
    classes do, on both layouts and both routes."""
    dkh, dvh = head
    cls, nk, nv = width_plan(dkh, dvh)
    assert cls == WIDTH_CLASSES[-1] and (nk, nv) != (1, 1)
    _match_plain(dkh, dvh, *geo, layout, dtype)


# the tensor-core passes' own cases of heads past the largest class: tiny
# maps, several (batch, head) pairs a tile, B*nh not a multiple of the pack
# (1x1 packs 64, 2x2 16, 4x4 4); maps whose tokens are not a multiple of the
# 64-token tile (10x10, 20x20); the ragged (150, 75)
PACK_CASES = [((512, 256), (5, 13, 1, 1)), ((160, 64), (3, 5, 2, 2)),
              ((320, 128), (3, 3, 4, 4)), ((160, 64), (1, 3, 10, 10)),
              ((150, 75), (1, 2, 20, 20)), ((150, 75), (2, 3, 10, 10))]


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("head,geo", PACK_CASES, ids=lambda x: "x".join(map(str, x)))
def test_wide_heads_packed_and_ragged_maps(cuda, head, geo, layout):
    """bf16 heads past (128, 64) on the tensor-core passes (wide_bwd_plan
    finds room for both) at packed tiny maps and ragged token counts match
    the plain versions."""
    dkh, dvh = head
    B, nh, H, W = geo
    plan = wide_bwd_plan(H, W, dkh, dvh, layout)
    assert plan["dq"] is not None and plan["dkdv"] is not None
    assert plan["pack"] == bwd_pack(H, W, dkh, dvh)
    assert plan["pack"] == 1 or (B * nh) % plan["pack"] != 0
    _match_plain(dkh, dvh, B, nh, H, W, layout, torch.bfloat16)


@pytest.mark.parametrize("head,geo", [((160, 64), (1, 2, 8, 8)), ((150, 75), (2, 3, 4, 4)),
                                      ((129, 8), (1, 3, 5, 7))],
                         ids=lambda x: "x".join(map(str, x)))
def test_wide_heads_on_unaligned_slots(cuda, head, geo):
    """Heads-in-lanes slots of 2 dkh + dvh + 3 lanes (odd): q, k and v lanes
    start off 16, 8 and 4 bytes, so the tensor-core passes stage them by
    narrower copies and 2-byte loads, and match the plain versions."""
    dkh, dvh = head
    _match_plain(dkh, dvh, *geo, "hil", torch.bfloat16, slot=2 * dkh + dvh + 3)


# the tensor-core forward's own cases of heads past the largest class:
# ((dkh, dvh), (B, nh, H, W)) with pair counts past one wave of blocks, so
# that tiny maps pack 2 to 4 pairs a tile and the last pack is partial (1x1,
# 2x2, 4x4; the width rows' 1x1 at about 256 x 2 pairs); the ragged (150, 75)
# at 1x1, 8x8 and 10x10; the widest head, (640, 320), in two warp groups;
# (320, 160) at 16x16
FWD_CASES = [((512, 256), (5, 67, 1, 1)), ((160, 64), (7, 143, 2, 2)),
             ((320, 128), (3, 401, 4, 4)), ((150, 75), (1, 1001, 1, 1)),
             ((512, 256), (255, 2, 1, 1)), ((150, 75), (2, 2, 8, 8)),
             ((150, 75), (2, 3, 10, 10)), ((640, 320), (2, 1, 8, 8)),
             ((320, 160), (1, 1, 16, 16))]


def _forward(layout, dkh, dvh, B, nh, H, W, dtype=torch.bfloat16, slot=None):
    """(kernel out, kernel lse, plain out, plain lse) of B1 / B5 at the head
    and map, one launch of the forward and no other kernel."""
    kernels.reset_launch_counts()
    if layout == "bn":
        qr, k, v = _inputs(B, nh, H, W, dvh, dtype, dkh=dkh)
        got = rel_attention_fwd(qr, k, v, H, W, dkh)
        want = rel_attention_fwd_plain(qr, k, v, H, W, dkh)
        name = NAME
    else:
        slot = slot or hil_slot(dkh, dvh)
        P0, Rw, Rh = _hil_inputs(B, nh, H, W, dvh, dtype, slot, dkh=dkh)
        got = hil_attention_fwd(P0, Rw, Rh, H, W, dkh, dvh, slot)
        want = hil_attention_fwd_plain(P0, Rw, Rh, H, W, dkh, dvh, slot)
        name = FWD
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {name: 1}
    return (*got, *want)


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("head,geo", FWD_CASES, ids=lambda x: "x".join(map(str, x)))
def test_wide_forward_matches_plain(cuda, head, geo, layout):
    """The tensor-core forward (wide_fwd_plan finds room) at packed tiny maps
    whose pair count is not a multiple of the pack, ragged heads and tokens
    and the widest head: out and lse within TOL of the plain version."""
    dkh, dvh = head
    B, nh, H, W = geo
    plan = wide_fwd_plan(H, W, dkh, dvh, B * nh, sm_count(torch.device("cuda", 0)))
    assert plan is not None
    assert plan["pack"] == fwd_pack(H, W, dkh, dvh, B * nh, sm_count(torch.device("cuda", 0)))
    assert plan["pack"] == 1 or (B * nh) % plan["pack"] != 0
    out, lse, out_p, lse_p = _forward(layout, dkh, dvh, B, nh, H, W)
    _check_close("out", out, out_p, TOL[torch.bfloat16], False)
    _check_close("lse", lse, lse_p, TOL[torch.bfloat16], False)


@pytest.mark.parametrize("head,geo", [((512, 256), (4, 70, 1, 1)), ((160, 64), (1, 2, 8, 8)),
                                      ((150, 75), (2, 3, 4, 4)), ((640, 320), (1, 2, 8, 8))],
                         ids=lambda x: "x".join(map(str, x)))
def test_wide_forward_on_unaligned_slots(cuda, head, geo):
    """Heads-in-lanes slots of 2 dkh + dvh + 3 lanes: the forward stages q, k
    and v by narrower copies and 2-byte loads (packed too) and matches the
    plain version."""
    dkh, dvh = head
    out, lse, out_p, lse_p = _forward("hil", dkh, dvh, *geo, slot=2 * dkh + dvh + 3)
    _check_close("out", out, out_p, TOL[torch.bfloat16], False)
    _check_close("lse", lse, lse_p, TOL[torch.bfloat16], False)


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("head,geo", [((512, 256), (5, 67, 1, 1)), ((640, 320), (2, 1, 8, 8)),
                                      ((160, 64), (1, 2, 16, 16))],
                         ids=lambda x: "x".join(map(str, x)))
def test_wide_forward_is_deterministic(cuda, head, geo, layout):
    """Two forward calls on the same inputs give bit-equal out and lse."""
    dkh, dvh = head
    a = _forward(layout, dkh, dvh, *geo)
    b = _forward(layout, dkh, dvh, *geo)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# plans that the tensor-core forward refuses at (320, 128) on 8x8, made from
# the one fwd_plan_args chooses: shared memory 16 bytes off its count, tk 64,
# 17 column groups of out's 16 n8 tiles (the last one empty), a pack of 2 on
# a map of 64 tokens, three warp groups a block
FWD_BAD_PLANS = {"smem": lambda p: (*p[:4], p[4] + 16), "tk": lambda p: (*p[:3], 64, p[4]),
                 "groups": lambda p: (p[0], 17, *p[2:]), "pack": lambda p: (2, *p[1:]),
                 "wg": lambda p: (*p[:2], 3, *p[3:])}


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("bad", sorted(FWD_BAD_PLANS))
def test_wide_forward_refuses_a_plan_it_cannot_run(cuda, monkeypatch, layout, bad):
    """The forward takes the plan of wide_fwd_plan from the wrapper
    (fwd_plan_args) and refuses one its kernel cannot run, its shared memory
    included: the wrapper raises and counts no launch."""
    from chexpert_tpu_torch.ops import fused_attention, hil_attention

    dkh, dvh, B, nh, H, W = 320, 128, 2, 1, 8, 8
    mod = fused_attention if layout == "bn" else hil_attention
    real = fused_attention.fwd_plan_args
    assert real(torch.bfloat16, H, W, dkh, dvh, B * nh)[3] in (16, 32)
    monkeypatch.setattr(mod, "fwd_plan_args", lambda *a: FWD_BAD_PLANS[bad](real(*a)))
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _forward(layout, dkh, dvh, B, nh, H, W)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {}


# pass drel's plans: 8x8 with one and two heads (batch elements share a
# block; 24 is not a multiple of bsplit), aaresnet152's 40x40 with 8 heads
# (one batch element a block), a head past the largest class
DREL_CASES = [(24, 1, 8, 8, 64, 32), (24, 2, 8, 8, 64, 32), (16, 8, 40, 40, 20, 1),
              (40, 1, 8, 8, 320, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nh,H,W,dkh,dvh", DREL_CASES)
def test_drel_matches_plain_on_every_plan(cuda, B, nh, H, W, dkh, dvh, dtype):
    """hil_attention_bwd_drel at drel_plan's split (threads a block >= 128
    where the batch allows) against its plain version, f32 sums within 1e-4
    relative to the largest entry."""
    hsplit, bsplit = drel_plan(B, H, W, nh, dkh)
    assert max(H, W) * hsplit * bsplit >= 128
    slot = hil_slot(dkh, dvh)
    P0, _, _ = _hil_inputs(B, nh, H, W, dvh, dtype, slot, relative=False, dkh=dkh)
    drc = torch.randn(B, nh, H * W, W + H, generator=torch.Generator().manual_seed(3)).cuda()
    kernels.reset_launch_counts()
    got = hil_attention_bwd_drel(P0, drc, H, W, dkh, slot, dvh)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {BWD_PASSES[2]: 1}
    for g, w in zip(got, hil_attention_bwd_drel_plain(P0, drc, H, W, dkh, slot)):
        _check_close("dR", g, w, BWD_TOL[torch.float32], True)


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("head,geo", [((320, 128), (2, 2, 8, 8)), ((512, 256), (3, 5, 1, 1)),
                                      ((64, 32), (2, 2, 8, 8))],
                         ids=lambda x: "x".join(map(str, x)))
def test_backward_is_deterministic(cuda, head, geo, layout):
    """Two backward calls on the same inputs give bit-equal dq / dk / dv (dP)
    and dRw / dRh: every block owns what it writes and sums in a fixed
    order."""
    dkh, dvh = head
    B, nh, H, W = geo
    dout_gen = torch.Generator().manual_seed(1)
    if layout == "bn":
        qr, k, v = _inputs(B, nh, H, W, dvh, torch.bfloat16, dkh=dkh)
        out, lse = rel_attention_fwd(qr, k, v, H, W, dkh)
        dout = torch.randn(out.shape, generator=dout_gen).to("cuda", torch.bfloat16)
        runs = [rel_attention_bwd(qr, k, v, out, lse, dout, H, W, dkh) for _ in range(2)]
    else:
        geo5 = (H, W, dkh, dvh, hil_slot(dkh, dvh))
        P0, Rw, Rh = _hil_inputs(B, nh, H, W, dvh, torch.bfloat16, geo5[4], dkh=dkh)
        out, lse = hil_attention_fwd(P0, Rw, Rh, *geo5)
        dout = torch.randn(out.shape, generator=dout_gen).to("cuda", torch.bfloat16)
        runs = [hil_attention_bwd(P0, Rw, Rh, out, lse, dout, *geo5) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# plans (pack, column groups, warp groups, tk, shared memory) that the
# tensor-core passes refuse at (320, 128) on 8x8, made from the one that
# wide_bwd_plan chooses: shared memory 16 bytes off its count, tk 64, one
# column group where the tiles need two, a pack of 2 on a map of 64 tokens,
# three warp groups a block
BAD_PLANS = {"smem": lambda p: (*p[:4], p[4] + 16), "tk": lambda p: (*p[:3], 64, p[4]),
             "groups": lambda p: (p[0], 1, 1, *p[3:]), "pack": lambda p: (2, *p[1:]),
             "wg": lambda p: (*p[:2], 3, *p[3:])}


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("pass_name", ["dq", "dkdv"])
@pytest.mark.parametrize("bad", sorted(BAD_PLANS))
def test_wide_entries_refuse_a_plan_they_cannot_run(cuda, monkeypatch, layout, pass_name, bad):
    """The tensor-core passes take the plan of wide_bwd_plan from the wrapper
    (bwd_plan_args) and refuse one their kernels cannot run, its shared
    memory included: the wrapper raises and counts no launch of the pass."""
    from chexpert_tpu_torch.ops import fused_attention, hil_attention

    dkh, dvh, B, nh, H, W = 320, 128, 2, 1, 8, 8
    mod = fused_attention if layout == "bn" else hil_attention
    real = fused_attention.bwd_plan_args
    assert real(pass_name, torch.bfloat16, H, W, dkh, dvh, layout)[3] in (16, 32)
    monkeypatch.setattr(mod, "bwd_plan_args", lambda name, *a: (
        BAD_PLANS[bad](real(name, *a)) if name == pass_name else real(name, *a)))
    dout_gen = torch.Generator().manual_seed(1)
    if layout == "bn":
        qr, k, v = _inputs(B, nh, H, W, dvh, torch.bfloat16, dkh=dkh)
        out, lse = rel_attention_fwd(qr, k, v, H, W, dkh)
        dout = torch.randn(out.shape, generator=dout_gen).to("cuda", torch.bfloat16)
        kernels.reset_launch_counts()
        with pytest.raises(RuntimeError, match="cudaError 1"):
            rel_attention_bwd(qr, k, v, out, lse, dout, H, W, dkh)
        name = BWD_DQ if pass_name == "dq" else BWD_DKDV
    else:
        geo5 = (H, W, dkh, dvh, hil_slot(dkh, dvh))
        P0, Rw, Rh = _hil_inputs(B, nh, H, W, dvh, torch.bfloat16, geo5[4], dkh=dkh)
        out, lse = hil_attention_fwd(P0, Rw, Rh, *geo5)
        dout = torch.randn(out.shape, generator=dout_gen).to("cuda", torch.bfloat16)
        kernels.reset_launch_counts()
        with pytest.raises(RuntimeError, match="cudaError 1"):
            hil_attention_bwd(P0, Rw, Rh, out, lse, dout, *geo5)
        name = BWD_PASSES[1] if pass_name == "dq" else BWD_PASSES[0]
    torch.cuda.synchronize()
    assert name not in kernels.launch_counts()


@pytest.mark.parametrize("dkh,dvh", [(0, 4), (20, 0)])
def test_widths_below_one_raise(cuda, dkh, dvh):
    """A head width below 1 raises ValueError on the card, naming its widths;
    nothing falls back to the plain route."""
    with pytest.raises(ValueError):
        width_class(dkh, dvh)
    kernels.reset_launch_counts()
    qr, k, v = _inputs(1, 2, 3, 4, max(dvh, 1), torch.float32, dkh=max(dkh, 1))
    if dvh == 0:
        v = v[..., :0]
    if dkh == 0:
        qr, k = qr[..., 1:].contiguous(), k[..., :0]
    with pytest.raises(ValueError, match=f"dkh={dkh}, dvh={dvh}"):
        rel_attention_fwd(qr, k, v, 3, 4, dkh)
    slot = max(hil_slot(max(dkh, 1), max(dvh, 1)), 2 * dkh + dvh)
    P0, _, _ = _hil_inputs(1, 2, 3, 4, max(dvh, 1), torch.float32, slot, relative=False,
                           dkh=max(dkh, 1))
    with pytest.raises(ValueError, match=f"dkh={dkh}, dvh={dvh}"):
        hil_attention_fwd(P0, None, None, 3, 4, dkh, dvh, slot)
    assert kernels.launch_counts() == {}


def test_ensemble_chunked_equals_unchunked_on_the_card(cuda, tmp_path):
    """Three aadensenet-tiny members through B1 (one AA transition): the
    planned chunk (all three) and chunk 1 give the same mean logits, losses
    and targets (the kernels are deterministic), and a pass launches B1 once
    per member per batch and no backward kernel."""
    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.data import Batches, ChexpertIndex, make_synthetic_dataset
    from chexpert_tpu_torch.eval import list_checkpoints
    from chexpert_tpu_torch.eval.ensemble import _plan_member_chunk, ensemble_outputs
    from chexpert_tpu_torch.models import build_model

    arch, root = "aadensenet-tiny", str(tmp_path)
    make_synthetic_dataset(root, n_train=4, n_valid=12, image_size=32)
    os.makedirs(os.path.join(root, "members"))
    for k in range(3):
        sd = build_model(arch, image_size=32, generator=torch.Generator().manual_seed(k)
                         ).state_dict()
        save_model_checkpoint(os.path.join(root, "members", f"checkpoint_{k}.pt"), sd, k)
    paths = list_checkpoints(os.path.join(root, "members"))
    model = build_model(arch, image_size=32, device=cuda)
    batches = Batches(ChexpertIndex(root, "valid"), 4, image_size=32, workers=2)
    chunk = _plan_member_chunk(model, 3, batches, cuda, torch.float32)
    assert chunk == 3
    kernels.reset_launch_counts()
    full = ensemble_outputs(model, paths, batches, cuda, torch.float32, chunk, arch)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {NAME: 3 * 3}  # members x batches
    one = ensemble_outputs(model, paths, batches, cuda, torch.float32, 1, arch)
    for a, b in zip(full, one):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-6 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("arch,layout", [("aadensenet-tiny", "bn"), ("aadensenet-tiny", "hil"),
                                         ("efficientnet-b0", "bn")])
def test_grad_cam_launches_the_forward_kernels_only(cuda, arch, layout):
    """Grad-CAM records only the head: B1 / B5 / B3 launch once per layer and
    forward, and no backward kernel (B2, B6, B4) launches; the CAMs lie in
    [0, 1]. The attention capture takes the einsum route: no launch."""
    from chexpert_tpu_torch.interpret import capture_attention_weights, grad_cam
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.models.efficientnet import DepthwiseConv

    size = 32 if arch.startswith("aa") else 64
    model = build_model(arch, image_size=size, attn_layout=layout, device=cuda)
    n_dw = sum(1 for m in model.modules() if isinstance(m, DepthwiseConv) and m.stride == 1)
    want = {DW_FWD: n_dw} if n_dw else {FWD if layout == "hil" else NAME: 1}
    x = torch.randn(3, 3, size, size, generator=torch.Generator().manual_seed(0)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        cam, logits = grad_cam(model, x, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == want, dtype
        assert cam.shape == (3, 1, size, size) and torch.isfinite(cam).all()
        assert cam.min() >= 0 and cam.max() <= 1 and logits.shape == (3, 5)
        kernels.reset_launch_counts()
        weights = capture_attention_weights(model, x, compute_dtype=dtype)
        assert kernels.launch_counts() == {}
        for w in weights:
            assert torch.allclose(torch.from_numpy(w).sum(-1), torch.ones(()), atol=1e-3)


def test_bench_to_device_equals_the_host(cuda):
    """At batch 256 the card's uint8 route gives ``normalize`` + permute bit
    for bit, as contiguous NCHW f32. Two calls back to back, no sync between,
    the first batch's host array overwritten after its call: each result is
    the batch it was handed."""
    rng = np.random.RandomState(0)
    xs = [rng.randint(0, 256, (256, 32, 32, 3)).astype(np.uint8) for _ in range(2)]
    wants = [torch.from_numpy(bench.normalize(x)).permute(0, 3, 1, 2).contiguous() for x in xs]
    first = bench.to_device(xs[0], cuda)
    xs[0][:] = 0
    got = [first, bench.to_device(xs[1], cuda)]
    for g, want in zip(got, wants):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        assert g.shape == (256, 3, 32, 32) and g.is_contiguous()
        assert torch.equal(g.cpu(), want)
