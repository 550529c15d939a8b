"""The port's attention ops against the JAX package's, on the CPU.

Same numpy inputs go through both. JAX runs as its own tests run it on the
CPU (highest matmul precision from conftest, Pallas in interpret mode). All
comparisons are float32 with atol 1e-5: the same algorithm in f32, with a
different summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.ops import attention as jattn
from chexpert_tpu.ops.pallas_attention import _flash_forward, _geometry, _unrows
from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops import attention as tattn
from chexpert_tpu_torch.ops.fused_attention import (
    NAME,
    rel_attention_fwd,
    rel_attention_fwd_plain,
)

ATOL = 1e-5


def _qkv(rng, B, nh, H, W, dkh, dvh):
    hw = H * W
    q = (rng.randn(B, nh, hw, dkh) * dkh ** -0.5).astype(np.float32)
    k = rng.randn(B, nh, hw, dkh).astype(np.float32)
    v = rng.randn(B, nh, hw, dvh).astype(np.float32)
    rel_w = rng.randn(dkh, 2 * W - 1).astype(np.float32)
    rel_h = rng.randn(dkh, 2 * H - 1).astype(np.float32)
    return q, k, v, rel_w, rel_h


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("relative", [True, False])
def test_aa_attention_einsum_matches_jax(relative):
    rng = np.random.RandomState(0)
    B, nh, H, W, dkh, dvh = 2, 2, 6, 5, 20, 3
    q, k, v, rel_w, rel_h = _qkv(rng, B, nh, H, W, dkh, dvh)
    rw, rh = (rel_w, rel_h) if relative else (None, None)
    jout, jw = jattn.aa_attention_einsum(
        *map(jnp.asarray, (q, k, v)), None if rw is None else jnp.asarray(rw),
        None if rh is None else jnp.asarray(rh), H, W, return_weights=True)
    tout, tw = tattn.aa_attention_einsum(
        *_t(q, k, v), None if rw is None else torch.from_numpy(rw),
        None if rh is None else torch.from_numpy(rh), H, W, return_weights=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


def test_relative_logits_match_jax():
    rng = np.random.RandomState(1)
    B, nh, H, W, dkh = 2, 2, 6, 5, 20
    q, _, _, rel_w, rel_h = _qkv(rng, B, nh, H, W, dkh, 1)
    q2d = q.reshape(B, nh, H, W, dkh)
    jrw, jrh = jattn.relative_logits_compact(*map(jnp.asarray, (q2d, rel_w, rel_h)))
    trw, trh = tattn.relative_logits_compact(*_t(q2d, rel_w, rel_h))
    np.testing.assert_allclose(trw.numpy(), np.asarray(jrw), atol=ATOL)
    np.testing.assert_allclose(trh.numpy(), np.asarray(jrh), atol=ATOL)
    jfull = jattn.relative_logits(*map(jnp.asarray, (q2d, rel_w, rel_h)))
    tfull = tattn.relative_logits(*_t(q2d, rel_w, rel_h))
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), atol=ATOL)


@pytest.mark.parametrize("relative", [True, False])
def test_pack_query_matches_jax_packs(relative):
    """The port's one pack equals the JAX fusedpack ([q;RW] from the
    block-diagonal matmul + RH) and einsum packs, and [q ; 0] when
    relative=False (aa_attention_pallas's qr)."""
    rng = np.random.RandomState(2)
    B, nh, H, W, dkh = 2, 2, 6, 5, 20
    q, _, _, rel_w, rel_h = _qkv(rng, B, nh, H, W, dkh, 1)
    if relative:
        jq, jw, jh = map(jnp.asarray, (q, rel_w, rel_h))
        fused = jnp.concatenate(
            [jattn.packed_q_relw_bd(jq, jw, H, W),
             jattn.rel_h_compact(jq.reshape(B, nh, H, W, dkh), jh)], axis=-1)
        rw, rh = jattn.relative_logits_compact(jq.reshape(B, nh, H, W, dkh), jw, jh)
        plain = jnp.concatenate([jq, rw, rh], axis=-1)
        tqr = tattn.pack_query(*_t(q, rel_w, rel_h), H, W).numpy()
        np.testing.assert_allclose(tqr, np.asarray(fused), atol=ATOL)
        np.testing.assert_allclose(tqr, np.asarray(plain), atol=ATOL)
    else:
        tqr = tattn.pack_query(torch.from_numpy(q), None, None, H, W).numpy()
        want = np.concatenate([q, np.zeros((B, nh, H * W, W + H), np.float32)], -1)
        np.testing.assert_array_equal(tqr, want)


@pytest.mark.parametrize("B,nh,H,W,dvh", [
    (2, 2, 6, 5, 1), (2, 2, 6, 5, 3), (2, 2, 6, 5, 6),
    (2, 2, 10, 10, 1), (2, 2, 10, 10, 3), (2, 2, 10, 10, 6),
    (1, 8, 10, 10, 6),  # aadensenet121 transition-3 geometry
])
def test_rel_attention_fwd_plain_matches_flash_forward(B, nh, H, W, dvh):
    """The kernel's plain version (what the CPU wrapper runs) against the JAX
    Pallas forward: out and lse."""
    rng = np.random.RandomState(3)
    dkh, hw = 20, H * W
    L = dkh + W + H
    qr = rng.randn(B, nh, hw, L).astype(np.float32)
    qr[..., :dkh] *= dkh ** -0.5
    k = rng.randn(B, nh, hw, dkh).astype(np.float32)
    v = rng.randn(B, nh, hw, dvh).astype(np.float32)

    jout, res = _flash_forward(*map(jnp.asarray, (qr, k, v)), H, W, dkh)
    _, _, hwp, _ = _geometry(hw, B * nh, dkh, dvh, W + H, 4)
    jlse = np.asarray(_unrows(res[4], hwp))[:, :hw]

    bn = B * nh
    tout, tlse = rel_attention_fwd(
        *_t(qr.reshape(bn, hw, L), k.reshape(bn, hw, dkh), v.reshape(bn, hw, dvh)),
        H, W, dkh)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout).reshape(bn, hw, dvh), atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=ATOL)


def test_plain_matches_einsum_through_pack():
    """pack_query -> plain fused forward == aa_attention_einsum (the model's
    two attention routes agree)."""
    rng = np.random.RandomState(4)
    B, nh, H, W, dkh, dvh = 2, 2, 6, 5, 20, 3
    q, k, v, rel_w, rel_h = _t(*_qkv(rng, B, nh, H, W, dkh, dvh))
    qr = tattn.pack_query(q, rel_w, rel_h, H, W)
    out, _ = rel_attention_fwd_plain(qr.reshape(B * nh, H * W, -1),
                                     k.reshape(B * nh, H * W, dkh),
                                     v.reshape(B * nh, H * W, dvh), H, W, dkh)
    ref, _ = tattn.aa_attention_einsum(q, k, v, rel_w, rel_h, H, W)
    np.testing.assert_allclose(out.reshape(ref.shape).numpy(), ref.numpy(), atol=ATOL)


def test_cpu_wrapper_counts_no_launch_and_absent_device_raises():
    rng = np.random.RandomState(5)
    H, W, dkh, dvh = 6, 5, 20, 2
    qr, k, v = _t(rng.randn(2, 30, dkh + W + H).astype(np.float32),
                  rng.randn(2, 30, dkh).astype(np.float32),
                  rng.randn(2, 30, dvh).astype(np.float32))
    kernels.reset_launch_counts()
    rel_attention_fwd(qr, k, v, H, W, dkh)
    assert kernels.launch_counts().get(NAME, 0) == 0
    # a device with no kernel raises instead of falling back
    with pytest.raises(ValueError, match="no kernel"):
        rel_attention_fwd(qr.to("meta"), k.to("meta"), v.to("meta"), H, W, dkh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kernels.load(NAME)
    with pytest.raises(ValueError):
        rel_attention_fwd(qr, k, v, H, W + 1, dkh)  # shapes checked first
