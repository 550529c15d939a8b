"""A CPU rehearsal of the rounding of the tensor-core attention forwards
(``csrc/attention_fwd_mma.cuh``: B1 head-major, B5 heads-in-lanes), held to
the card's gate against the f32 plain versions.

The bf16 kernels read bf16 operands, sum S = q k^T in f32, add the relative
logits (B1: the bf16 RW / RH lanes of qr; B5: f32 RC rows made as a product
with the embedding split into hi + lo bf16), run an online softmax over
tiles of 64 keys with an f32 running max, sum l from the f32 p, round p to
bf16 once for p v (f32 sums), and return out = o / l and lse = m + log l.
``_rehearsal`` does the same in plain torch; the card gate is today's TOL
(2e-2 on out and lse, bf16), which ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold the kernels to. The kernels of
every head-width class (dkh up to 128, dvh up to 64, padded in shared memory
only) hold the same gate at the widths the bench's flags reach."""

import numpy as np
import pytest
import torch

from chexpert_tpu_torch.ops.attention import pack_query
from chexpert_tpu_torch.ops.fused_attention import KEY_TILE, rel_attention_fwd_plain
from chexpert_tpu_torch.ops.fused_attention import _logits_plain as rel_logits
from chexpert_tpu_torch.ops.hil_attention import _logits_plain as hil_logits
from chexpert_tpu_torch.ops.hil_attention import (
    _unpack,
    hil_attention_fwd_plain,
    hil_rel_operand,
    hil_slot,
)

DKH = 20
TOL = 2e-2  # chip_smoke.py's TOL for bf16: one output rounding of |out| < 4


def _rounded(t):
    return t.to(torch.bfloat16).float()


def _rehearsal(s, v, round_p=True):
    """Online softmax over KEY_TILE-key tiles of f32 logits s (..., q, keys)
    and values v (..., keys, dvh): (out, lse) in f32."""
    m = torch.full(s.shape[:-1], -float("inf"))
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for j0 in range(0, s.shape[-1], KEY_TILE):
        st = s[..., j0:j0 + KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1))
        a = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * a + p.sum(-1)
        pv = (_rounded(p) if round_p else p) @ v[..., j0:j0 + KEY_TILE, :].float()
        o = o * a[..., None] + pv
        m = m_new
    return o / l[..., None], m + torch.log(l)


def _hi_lo(rel):
    """The embedding as the kernel stages it: hi + lo bf16 parts, in f32."""
    hi = _rounded(rel)
    return hi + _rounded(rel - hi)


def _b1(H, W, dvh, round_p, dkh=DKH):
    rng = np.random.RandomState(H * 100 + W * 10 + dvh + (dkh - DKH) * 1000)
    B, nh, hw = 2, 2, H * W
    q = torch.from_numpy((rng.randn(B, nh, hw, dkh) * dkh ** -0.5).astype(np.float32))
    rel_w = torch.from_numpy(rng.randn(dkh, 2 * W - 1).astype(np.float32))
    rel_h = torch.from_numpy(rng.randn(dkh, 2 * H - 1).astype(np.float32))
    qr = pack_query(q, rel_w, rel_h, H, W).reshape(B * nh, hw, -1).to(torch.bfloat16)
    k = torch.from_numpy(rng.randn(B * nh, hw, dkh).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.randn(B * nh, hw, dvh).astype(np.float32)).to(torch.bfloat16)
    got = _rehearsal(rel_logits(qr, k, H, W, dkh), v, round_p)
    want_f32 = rel_attention_fwd_plain(qr, k, v.float(), H, W, dkh)
    return got, rel_attention_fwd_plain(qr, k, v, H, W, dkh), want_f32


def _b5(H, W, dvh, round_p, dkh=DKH):
    rng = np.random.RandomState(H * 100 + W * 10 + dvh + 1 + (dkh - DKH) * 1000)
    B, nh, hw = 2, 2, H * W
    slot = hil_slot(dkh, dvh)
    q = rng.randn(B, hw, nh, dkh) * dkh ** -0.5
    kv = rng.randn(B, hw, nh, dkh + dvh)
    pad = np.zeros((B, hw, nh, slot - 2 * dkh - dvh))
    P0 = torch.from_numpy(np.concatenate([q, kv, pad], -1).reshape(B, hw, nh * slot)
                          .astype(np.float32)).to(torch.bfloat16)
    rel_w = torch.from_numpy(rng.randn(dkh, 2 * W - 1).astype(np.float32))
    rel_h = torch.from_numpy(rng.randn(dkh, 2 * H - 1).astype(np.float32))
    Rw, Rh = hil_rel_operand(rel_w, W), hil_rel_operand(rel_h, H)
    qh, kh, vh = _unpack(P0, nh, dkh, dvh, slot)
    s = hil_logits(qh, kh, hil_rel_operand(_hi_lo(rel_w), W), hil_rel_operand(_hi_lo(rel_h), H),
                   H, W)
    o, lse = _rehearsal(s, vh, round_p)
    got = o.permute(0, 2, 1, 3).reshape(B, hw, nh * dvh), lse
    geo = (H, W, dkh, dvh, slot)
    want = hil_attention_fwd_plain(P0, Rw, Rh, *geo)
    want_f32 = hil_attention_fwd_plain(P0.float(), Rw, Rh, *geo)
    return got, want, want_f32


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("dvh", [1, 3, 6])
@pytest.mark.parametrize("H,W", [(6, 5), (8, 8), (9, 9)])  # one ragged tile, one whole, a tail
def test_tensor_core_forward_rounding_holds_the_card_gate(layout, H, W, dvh):
    """The rehearsal, out rounded to bf16, against the plain version on the
    same bf16 inputs within the card's gate; the rounding of p is really in
    it (its f32 out differs from the f32 plain out), and without that
    rounding the tiled online softmax is the plain softmax."""
    run = _b1 if layout == "bn" else _b5
    (out, lse), (out_p, lse_p), (out_f32, _) = run(H, W, dvh, round_p=True)
    assert out_p.dtype == torch.bfloat16
    assert (_rounded(out) - out_p.float()).abs().max().item() <= TOL
    assert (lse - lse_p).abs().max().item() <= TOL
    assert (out - out_f32).abs().max().item() > 0
    (out, lse), _, (out_f32, lse_f32) = run(H, W, dvh, round_p=False)
    tight = 1e-5 if layout == "bn" else 1e-4  # B5: RC from hi + lo parts, ~2^-16 relative
    assert (out - out_f32).abs().max().item() <= tight
    assert (lse - lse_f32).abs().max().item() <= tight


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("dkh,dvh", [(26, 12), (32, 16), (64, 32), (128, 64)])
def test_tensor_core_forward_rounding_holds_the_card_gate_at_wider_heads(layout, dkh, dvh):
    """The same rehearsal at the heads of the wider width classes (the
    kernels pad dkh to KW and dvh to VW with zeros, which change no sum): the
    gate holds with more terms per dot, the rounding of p is in it, and
    without that rounding the tiled online softmax is the plain softmax."""
    run = _b1 if layout == "bn" else _b5
    H, W = 9, 9  # two key tiles, the second ragged
    (out, lse), (out_p, lse_p), (out_f32, _) = run(H, W, dvh, True, dkh)
    assert (_rounded(out) - out_p.float()).abs().max().item() <= TOL
    assert (lse - lse_p).abs().max().item() <= TOL
    assert (out - out_f32).abs().max().item() > 0
    (out, lse), _, (out_f32, lse_f32) = run(H, W, dvh, False, dkh)
    tight = 1e-5 if layout == "bn" else 1e-4
    assert (out - out_f32).abs().max().item() <= tight
    assert (lse - lse_f32).abs().max().item() <= tight
