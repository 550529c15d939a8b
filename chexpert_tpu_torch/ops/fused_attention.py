"""Fused relative-position attention: wrappers of the hand-written CUDA
kernels ``csrc/rel_attention_fwd.cu`` (B1) and ``csrc/rel_attention_bwd.cu``
(B2), their plain PyTorch versions, and the autograd function that joins
them.

Ports of the TPU kernels chexpert_tpu/ops/pallas_attention.py::_fwd_kernel
(host side ``_flash_forward``) and ``_bwd_kernel`` (host side
``_flash_bwd_rule``). The wrappers take the packed query operand of
``ops.attention.pack_query`` flattened to (B*nh, HW, L):

  * a CUDA tensor launches the kernel (or raises: there is no fallback);
  * a CPU tensor runs the ``*_plain`` version, the same function in plain
    torch ops. Nothing on the card path calls it; ``chip_smoke.py`` holds the
    kernels against it on the card.

``RelAttention.apply`` is what a model calls: its forward is B1 and its
backward B2, and it returns the packed cotangent d[q ; RW ; RH] whole, so the
pack's own autograd carries dRW/dRH on to q and the relative embeddings (as
the JAX ``aa_attention_pallas`` leaves the pack outside its custom_vjp).
The bare forward wrapper refuses CUDA operands that require grad while grad
mode is on: its output has no ``grad_fn``, so gradients would be dropped.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chexpert_tpu_torch import kernels

NAME = "rel_attention_fwd"
BWD_SOURCE = "rel_attention_bwd"  # one source, two kernels (passes)
BWD_DKDV = "rel_attention_bwd_dkdv"
BWD_DQ = "rel_attention_bwd_dq"
SUPPORTED_DKH = (20,)  # head widths the kernels are instantiated for
MAX_DVH = 8
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def key_positions(hw: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col, row) image coordinates of each key token, row-major."""
    j = torch.arange(hw, device=device)
    return j % W, j // W


def _logits_plain(qr, k, H: int, W: int, dkh: int) -> torch.Tensor:
    """f32 S = q.k^T + RW[:, col(j)] + RH[:, row(j)]; call with autocast off."""
    col, row = key_positions(H * W, W, qr.device)
    qf = qr.float()
    return (torch.bmm(qf[..., :dkh], k.float().transpose(1, 2))
            + qf[..., dkh:dkh + W][..., col] + qf[..., dkh + W:][..., row])


def rel_attention_fwd_plain(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            H: int, W: int, dkh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense softmax in f32. Returns (out in v's dtype, lse f32)."""
    with torch.autocast(qr.device.type, enabled=False):
        s = _logits_plain(qr, k, H, W, dkh)
        lse = torch.logsumexp(s, dim=-1)
        out = torch.bmm(torch.exp(s - lse[..., None]), v.float())
    return out.to(v.dtype), lse


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dout * out) in f32, (bn, hw): B2's softmax correction
    (computed outside the kernel, as the JAX host side does in XLA)."""
    return (dout.float() * out.float()).sum(-1)


def _ds_plain(qr, k, v, lse, delta, dout, H, W, dkh):
    """(p, ds) in f32: p = exp(S - lse), ds = p (dout v^T - delta)."""
    p = torch.exp(_logits_plain(qr, k, H, W, dkh) - lse[..., None])
    dp = torch.bmm(dout.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def rel_attention_bwd_dkdv_plain(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 1 of B2 in plain ops: (dk, dv) in k's / v's dtype."""
    with torch.autocast(qr.device.type, enabled=False):
        p, ds = _ds_plain(qr, k, v, lse, delta, dout, H, W, dkh)
        dv = torch.bmm(p.transpose(1, 2), dout.float())
        dk = torch.bmm(ds.transpose(1, 2), qr[..., :dkh].float())
    return dk.to(k.dtype), dv.to(v.dtype)


def rel_attention_bwd_dq_plain(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 2 of B2 in plain ops: dqr = [ds k ; dRW ; dRH] in qr's dtype, the
    bins summing ds over the keys of one image column / row."""
    bn, hw, _ = qr.shape
    with torch.autocast(qr.device.type, enabled=False):
        _, ds = _ds_plain(qr, k, v, lse, delta, dout, H, W, dkh)
        dq = torch.bmm(ds, k.float())
        ds4 = ds.reshape(bn, hw, H, W)  # key j = row * W + col
        dqr = torch.cat([dq, ds4.sum(2), ds4.sum(3)], dim=-1)
    return dqr.to(qr.dtype)


def rel_attention_bwd_plain(qr, k, v, out, lse, dout, H: int, W: int, dkh: int):
    """The whole backward in plain ops: (dqr, dk, dv)."""
    delta = attention_delta(out, dout)
    dk, dv = rel_attention_bwd_dkdv_plain(qr, k, v, dout, lse, delta, H, W, dkh)
    return rel_attention_bwd_dq_plain(qr, k, v, dout, lse, delta, H, W, dkh), dk, dv


def _check(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int, W: int, dkh: int):
    if qr.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("qr, k, v must be (B*nh, HW, features)")
    bn, hw, L = qr.shape
    if hw != H * W or L != dkh + W + H:
        raise ValueError(f"qr {tuple(qr.shape)} does not match H={H} W={W} dkh={dkh}")
    if k.shape != (bn, hw, dkh) or v.shape[:2] != (bn, hw):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match qr {tuple(qr.shape)}")
    if not (qr.device == k.device == v.device):
        raise ValueError("qr, k, v must be on one device")


def _check_bwd(qr, v, dout, lse, delta):
    bn, hw, _ = qr.shape
    if dout.shape != v.shape or lse.shape != (bn, hw) or delta.shape != (bn, hw):
        raise ValueError(f"dout {tuple(dout.shape)} / lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} do not match v {tuple(v.shape)}")
    if not (dout.device == lse.device == delta.device == qr.device):
        raise ValueError("all operands must be on one device")


def _kernel_entry(name: str, source: str, operands, f32_operands, dkh: int, dvh: int):
    """Validate what the kernel takes and return its ctypes entry."""
    if operands[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {operands[0].device}")
    if dkh not in SUPPORTED_DKH or not 1 <= dvh <= MAX_DVH:
        raise ValueError(f"{name}: kernel takes dkh in {SUPPORTED_DKH} and dvh in "
                         f"1..{MAX_DVH}, got dkh={dkh} dvh={dvh}")
    dt = operands[0].dtype
    if dt not in _DTYPE_SUFFIX or any(t.dtype != dt for t in operands):
        raise ValueError(f"{name}: operands must share one dtype of "
                         f"{list(_DTYPE_SUFFIX)}, got {[t.dtype for t in operands]}")
    if any(t.dtype != torch.float32 for t in f32_operands):
        raise ValueError(f"{name}: lse / delta must be float32")
    if not all(t.is_contiguous() for t in (*operands, *f32_operands)):
        raise ValueError(f"{name}: operands must be contiguous")
    if operands[0].shape[0] > 65535:
        raise ValueError(f"{name}: bn={operands[0].shape[0]} exceeds the grid's y limit")
    return getattr(kernels.load(source), f"{name}_{_DTYPE_SUFFIX[dt]}")


def rel_attention_fwd(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      H: int, W: int, dkh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """qr (bn, HW, dkh+W+H) packed [q ; RW ; RH], k (bn, HW, dkh),
    v (bn, HW, dvh) -> (out (bn, HW, dvh) in the operand dtype, lse (bn, HW) f32).
    Not differentiable on the card: use ``RelAttention.apply`` for training."""
    _check(qr, k, v, H, W, dkh)
    if qr.device.type == "cpu":
        return rel_attention_fwd_plain(qr, k, v, H, W, dkh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qr, k, v)):
        raise RuntimeError(f"{NAME}: operands require grad but the raw kernel wrapper has no "
                           "backward; call RelAttention.apply (forward B1, backward B2)")
    bn, hw, _ = qr.shape
    dvh = v.shape[-1]
    fn = _kernel_entry(NAME, NAME, (qr, k, v), (), dkh, dvh)
    out = torch.empty((bn, hw, dvh), dtype=v.dtype, device=qr.device)
    lse = torch.empty((bn, hw), dtype=torch.float32, device=qr.device)
    kernels.launch(NAME, fn, [t.data_ptr() for t in (qr, k, v, out, lse)],
                   [bn, hw, H, W, dkh, dvh], qr.device)
    return out, lse


def rel_attention_bwd_dkdv(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 1 of B2: (dk, dv) in the operand dtype."""
    _check(qr, k, v, H, W, dkh)
    _check_bwd(qr, v, dout, lse, delta)
    if qr.device.type == "cpu":
        return rel_attention_bwd_dkdv_plain(qr, k, v, dout, lse, delta, H, W, dkh)
    bn, hw, _ = qr.shape
    fn = _kernel_entry(BWD_DKDV, BWD_SOURCE, (qr, k, v, dout), (lse, delta), dkh, v.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernels.launch(BWD_DKDV, fn,
                   [t.data_ptr() for t in (qr, k, v, dout, lse, delta, dk, dv)],
                   [bn, hw, H, W, dkh, v.shape[-1]], qr.device)
    return dk, dv


def rel_attention_bwd_dq(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 2 of B2: dqr = [dq ; dRW ; dRH] in the operand dtype."""
    _check(qr, k, v, H, W, dkh)
    _check_bwd(qr, v, dout, lse, delta)
    if qr.device.type == "cpu":
        return rel_attention_bwd_dq_plain(qr, k, v, dout, lse, delta, H, W, dkh)
    bn, hw, _ = qr.shape
    fn = _kernel_entry(BWD_DQ, BWD_SOURCE, (qr, k, v, dout), (lse, delta), dkh, v.shape[-1])
    dqr = torch.empty_like(qr)
    kernels.launch(BWD_DQ, fn, [t.data_ptr() for t in (qr, k, v, dout, lse, delta, dqr)],
                   [bn, hw, H, W, dkh, v.shape[-1]], qr.device)
    return dqr


def rel_attention_bwd(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor, H: int, W: int, dkh: int):
    """B2: (dqr, dk, dv) in the dtypes of (qr, k, v), given the forward's
    out and lse and the output cotangent dout."""
    delta = attention_delta(out, dout)
    dk, dv = rel_attention_bwd_dkdv(qr, k, v, dout, lse, delta, H, W, dkh)
    return rel_attention_bwd_dq(qr, k, v, dout, lse, delta, H, W, dkh), dk, dv


class RelAttention(torch.autograd.Function):
    """out = softmax(S) v with forward B1 and backward B2 (plain versions for
    CPU tensors). Operands share one dtype; the backward runs with autocast
    off and returns each gradient in its operand's dtype."""

    @staticmethod
    def forward(ctx, qr, k, v, H: int, W: int, dkh: int):
        out, lse = rel_attention_fwd(qr, k, v, H, W, dkh)
        ctx.save_for_backward(qr, k, v, out, lse)
        ctx.geometry = (H, W, dkh)
        return out

    @staticmethod
    def backward(ctx, dout):
        qr, k, v, out, lse = ctx.saved_tensors
        with torch.autocast(qr.device.type, enabled=False):
            dqr, dk, dv = rel_attention_bwd(qr, k, v, out, lse,
                                            dout.to(v.dtype).contiguous(), *ctx.geometry)
        return dqr, dk, dv, None, None, None
