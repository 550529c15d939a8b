"""The port's attention backward (B2's plain version under ``RelAttention``)
against the JAX package's, on the CPU.

Same numpy inputs and output cotangent go through both. JAX differentiates
``aa_attention_pallas`` (its Pallas backward in interpret mode, highest
matmul precision from conftest); the port runs ``pack_query`` +
``RelAttention.apply`` under autograd. All comparisons are float32 with atol
1e-5: the same algorithm in f32 with a different summation order, on
gradients of magnitude ~1-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.ops.pallas_attention import aa_attention_pallas
from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops.attention import pack_query
from chexpert_tpu_torch.ops.fused_attention import (
    BWD_DKDV,
    BWD_DQ,
    RelAttention,
    rel_attention_bwd,
    rel_attention_bwd_plain,
    rel_attention_fwd,
    rel_attention_fwd_plain,
)

ATOL = 1e-5


def _inputs(seed, B, nh, H, W, dvh, dkh=20):
    rng = np.random.RandomState(seed)
    hw = H * W
    q = (rng.randn(B, nh, hw, dkh) * dkh ** -0.5).astype(np.float32)
    k = rng.randn(B, nh, hw, dkh).astype(np.float32)
    v = rng.randn(B, nh, hw, dvh).astype(np.float32)
    rel_w = (0.5 * rng.randn(dkh, 2 * W - 1)).astype(np.float32)
    rel_h = (0.5 * rng.randn(dkh, 2 * H - 1)).astype(np.float32)
    g = rng.randn(B, nh, hw, dvh).astype(np.float32)
    return q, k, v, rel_w, rel_h, g


def _port_grads(q, k, v, rel_w, rel_h, g, H, W, relative):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, rel_w, rel_h)]
    tq, tk, tv, tw, th = ts
    B, nh, hw, dkh = q.shape
    qr = pack_query(tq, tw if relative else None, th if relative else None, H, W)
    out = RelAttention.apply(qr.reshape(B * nh, hw, -1), tk.reshape(B * nh, hw, dkh),
                             tv.reshape(B * nh, hw, -1), H, W, dkh)
    out.reshape(g.shape).backward(torch.from_numpy(g))
    return out.detach().numpy().reshape(g.shape), [
        None if t.grad is None else t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,nh,H,W,dvh,relative", [
    (2, 2, 6, 5, 1, True),     # dvh 1 (the TPU's dv1 path), ragged
    (2, 2, 7, 11, 3, True),    # ragged, W != H
    (1, 2, 10, 10, 6, True),   # dvh 6 (aadensenet121's 10x10 transition)
    (2, 2, 8, 8, 2, True),     # aadensenet-tiny's first transition at 64^2
    (2, 2, 6, 5, 3, False),    # no relative embeddings
])
def test_grads_match_jax_aa_attention_pallas(B, nh, H, W, dvh, relative):
    q, k, v, rel_w, rel_h, g = _inputs(0, B, nh, H, W, dvh)

    def f(q_, k_, v_, w_, h_):
        out = aa_attention_pallas(q_, k_, v_, w_ if relative else None,
                                  h_ if relative else None, H, W)
        return jnp.sum(out * g), out

    jgrads, jout = jax.grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (q, k, v, rel_w, rel_h)))
    out, grads = _port_grads(q, k, v, rel_w, rel_h, g, H, W, relative)
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL)
    names = ("q", "k", "v", "rel_w", "rel_h")
    for name, got, want in zip(names, grads, jgrads):
        if not relative and name.startswith("rel"):
            assert got is None  # the [q ; 0] pack does not reach them
            continue
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("H,W,dvh", [(6, 5, 1), (7, 11, 4), (4, 4, 8)])
def test_bwd_plain_matches_autograd_of_fwd_plain(H, W, dvh):
    """B2's plain version (what the CPU wrapper and chip_smoke's reference
    run) equals autograd through B1's plain version, dRW/dRH lanes included."""
    rng = np.random.RandomState(1)
    bn, dkh, hw = 3, 20, H * W
    qr = torch.from_numpy(rng.randn(bn, hw, dkh + W + H).astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.randn(bn, hw, dkh).astype(np.float32)).requires_grad_()
    v = torch.from_numpy(rng.randn(bn, hw, dvh).astype(np.float32)).requires_grad_()
    dout = torch.from_numpy(rng.randn(bn, hw, dvh).astype(np.float32))
    out, lse = rel_attention_fwd_plain(qr, k, v, H, W, dkh)
    out.backward(dout)
    dqr, dk, dv = rel_attention_bwd_plain(qr.detach(), k.detach(), v.detach(),
                                          out.detach(), lse.detach(), dout, H, W, dkh)
    for got, want in ((dqr, qr.grad), (dk, k.grad), (dv, v.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_cpu_backward_counts_no_launch_and_guards():
    """On the CPU the wrappers take the plain versions (no kernel launch);
    operands without a kernel raise, and the bare forward takes grad-requiring
    CPU operands (it is differentiable there)."""
    H, W, dvh, dkh = 6, 5, 2, 20
    q, k, v, rel_w, rel_h, g = _inputs(2, 1, 2, H, W, dvh)
    kernels.reset_launch_counts()
    _port_grads(q, k, v, rel_w, rel_h, g, H, W, True)
    assert kernels.launch_counts().get(BWD_DKDV, 0) == 0
    assert kernels.launch_counts().get(BWD_DQ, 0) == 0
    qr = pack_query(*(torch.from_numpy(x) for x in (q, rel_w, rel_h)), H, W).reshape(2, 30, -1)
    kk, vv = torch.from_numpy(k).reshape(2, 30, dkh), torch.from_numpy(v).reshape(2, 30, dvh)
    out, lse = rel_attention_fwd(qr, kk, vv, H, W, dkh)
    meta = [t.to("meta") for t in (qr, kk, vv, out, lse, out)]
    with pytest.raises(ValueError, match="no kernel"):
        rel_attention_bwd(*meta, H, W, dkh)
    with pytest.raises(ValueError, match="do not match"):
        rel_attention_bwd(qr, kk, vv, out, lse, out[:, :, :1], H, W, dkh)
    out2, _ = rel_attention_fwd(qr.requires_grad_(), kk, vv, H, W, dkh)
    assert out2.grad_fn is not None


# --- a CPU rehearsal of the tensor-core kernels' rounding -----------------------

def _tensor_core_rehearsal(qr, k, v, dout, lse, delta, H, W, dkh):
    """The arithmetic of the bf16 kernels of ``csrc/rel_attention_bwd.cu`` in
    plain torch: bf16 operands, f32 sums, p and ds rounded to bf16 where they
    become matrix-product operands, the bins as a product with a one-hot of
    the keys' image column and row. Returns (dqr, dk, dv) in bf16."""
    from chexpert_tpu_torch.ops.fused_attention import key_positions

    def rounded(t):
        return t.to(torch.bfloat16).float()

    hw = H * W
    q, rel = qr[..., :dkh].float(), qr[..., dkh:].float()
    col, row = key_positions(hw, W, qr.device)
    s = q @ k.float().transpose(1, 2) + rel[..., :W][..., col] + rel[..., W:][..., row]
    p = torch.exp(s - lse[..., None])
    ds = rounded(p * (dout.float() @ v.float().transpose(1, 2) - delta[..., None]))
    p = rounded(p)
    onehot = torch.zeros(hw, W + H)
    onehot[torch.arange(hw), col] = 1.0
    onehot[torch.arange(hw), W + row] = 1.0
    dqr = torch.cat([ds @ k.float(), ds @ onehot], dim=-1)
    dk, dv = ds.transpose(1, 2) @ q, p.transpose(1, 2) @ dout.float()
    return [t.to(torch.bfloat16) for t in (dqr, dk, dv)]


@pytest.mark.parametrize("dvh", [1, 3, 6])
@pytest.mark.parametrize("H,W", [(6, 5), (8, 8)])
def test_tensor_core_rounding_holds_the_card_gate(H, W, dvh):
    """The rehearsal against the f32 plain backward on the same bf16 inputs,
    within the 1e-2 (relative to max(1, largest entry)) that the card gate
    holds the kernels to: bf16 keeps 2^-9 per rounded p or ds, and the sums
    over 30-64 keys average it."""
    from chexpert_tpu_torch.ops.fused_attention import attention_delta

    q, k, v, rel_w, rel_h, g = _inputs(11, 2, 2, H, W, dvh)
    B, nh, hw, dkh = q.shape
    qr = pack_query(torch.from_numpy(q), torch.from_numpy(rel_w), torch.from_numpy(rel_h), H, W)
    qr, tk, tv, dout = (t.reshape(B * nh, hw, -1).to(torch.bfloat16)
                        for t in (qr, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(g)))
    out, lse = rel_attention_fwd_plain(qr, tk, tv, H, W, dkh)
    want = rel_attention_bwd_plain(qr, tk, tv, out, lse, dout, H, W, dkh)
    got = _tensor_core_rehearsal(qr, tk, tv, dout, lse, attention_delta(out, dout), H, W, dkh)
    for name, a, b in zip(("dqr", "dk", "dv"), got, want):
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-2 * scale, (name, err, scale)
        assert err > 0 or name == "dv"  # the rounding is really in the rehearsal


@pytest.mark.parametrize("dkh,dvh", [(26, 12), (32, 16), (64, 32), (128, 64)])
def test_tensor_core_rounding_holds_the_card_gate_at_wider_heads(dkh, dvh):
    """The rehearsal at the heads of the wider width classes, whose kernels
    pad dkh to KW and dvh to VW in shared memory only (zeros that change no
    sum), within the same 1e-2 gate."""
    from chexpert_tpu_torch.ops.fused_attention import attention_delta

    H, W = 9, 9  # two key tiles, the second ragged
    q, k, v, rel_w, rel_h, g = _inputs(12, 2, 2, H, W, dvh, dkh=dkh)
    B, nh, hw, _ = q.shape
    qr = pack_query(torch.from_numpy(q), torch.from_numpy(rel_w), torch.from_numpy(rel_h), H, W)
    qr, tk, tv, dout = (t.reshape(B * nh, hw, -1).to(torch.bfloat16)
                        for t in (qr, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(g)))
    out, lse = rel_attention_fwd_plain(qr, tk, tv, H, W, dkh)
    want = rel_attention_bwd_plain(qr, tk, tv, out, lse, dout, H, W, dkh)
    got = _tensor_core_rehearsal(qr, tk, tv, dout, lse, attention_delta(out, dout), H, W, dkh)
    for name, a, b in zip(("dqr", "dk", "dv"), got, want):
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-2 * scale, (name, err, scale)
        assert err > 0 or name == "dv"


@pytest.mark.parametrize("H,W", [(1, 1), (6, 5), (7, 9), (8, 8), (10, 10), (40, 40), (33, 17)])
def test_key_table_is_the_one_hot_of_the_keys(H, W):
    """The table that the tensor-core dq pass reads, unpacked fragment by
    fragment, is the one-hot of every key's image column and row; the touched
    bits name exactly the bin tiles with a hit; padded keys hit nothing."""
    from chexpert_tpu_torch.ops.fused_attention import KEY_TILE, bin_tiles, key_table

    hw, nbw, nbt = H * W, -(-W // 8), bin_tiles(H, W)
    tab = key_table(H, W, torch.device("cpu"))
    tiles = -(-hw // KEY_TILE)
    n_frag = (KEY_TILE // 16) * nbt * 64
    assert tab.dtype == torch.int32 and tab.shape == (tiles, n_frag + KEY_TILE // 16 + KEY_TILE)
    frags = tab[:, :n_frag].reshape(tiles * (KEY_TILE // 16), nbt, 32, 2).long()
    touched = tab[:, n_frag:n_frag + KEY_TILE // 16].reshape(-1)
    kpos = tab[:, n_frag + KEY_TILE // 16:].reshape(-1)

    dense = torch.zeros(tiles * KEY_TILE, nbt * 8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, half in ((0, 0), (0, 1), (1, 0), (1, 1)):  # (b0 | b1, low | high half)
            bits = (frags[:, :, lane, reg] >> (16 * half)) & 0xFFFF  # (chunks, nbt)
            assert set(bits.unique().tolist()) <= {0, 0x3F80}
            key = torch.arange(frags.shape[0]) * 16 + 2 * t + 8 * reg + half
            for tile in range(nbt):
                dense[key, tile * 8 + g] = (bits[:, tile] != 0).float()
    want = torch.zeros_like(dense)
    j = torch.arange(hw)
    want[j, j % W] = 1.0
    want[j, nbw * 8 + j // W] = 1.0
    assert torch.equal(dense, want)
    hits = dense.reshape(-1, 16, nbt, 8).sum((1, 3)) > 0  # (chunks, nbt)
    assert torch.equal(touched.long(), (hits.long() << torch.arange(nbt)).sum(-1))
    assert torch.equal(kpos[:hw].long(), (j % W) | ((j // W) << 16))
    assert int(kpos[hw:].abs().sum()) == 0
