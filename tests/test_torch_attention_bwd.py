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
