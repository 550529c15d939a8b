"""Heads-in-lanes (token-major) relative-position attention: wrappers of the
hand-written CUDA kernels ``csrc/hil_attention_fwd.cu`` (B5) and
``csrc/hil_attention_bwd.cu`` (B6), their plain PyTorch versions, and the
autograd function that joins them.

Ports of the TPU kernels chexpert_tpu/ops/pallas_attention.py::
_hil_fwd_kernel (host side ``_hil_forward``) and ``_hil_bwd_kernel`` (host
side ``_hil_bwd_rule``). The operand is the 1x1 qkv projection's output as
it stands, token-major:

  P0  (B, HW, nh*slot)  per head one slot [q * dkh^-0.5 ; k ; v ; 0-pad]
  Rw  (W*dkh, W), Rh (H*dkh, H)  block operands of the relative logits,
      ``hil_rel_operand`` of the (dkh, 2n-1) embeddings; None for attention
      without relative logits
  out (B, HW, nh*dvh)   in P0's dtype, lanes ordered (head, dvh): out_proj's
      channel order
  lse (B, nh, HW) f32

so neither a head-split copy of q, k, v nor a head-merge copy of out exists
(the head-major layout of ``ops/fused_attention.py`` needs both). ``slot`` is
an explicit argument: any stride >= 2*dkh + dvh. ``hil_slot`` is the model's
choice, the next multiple of 8 (16 bytes in bf16, so every slot starts on a
16-byte boundary), which is 48 for every AAConv geometry of the model zoo.

  * a CUDA tensor launches the kernels (or raises: there is no fallback);
  * a CPU tensor runs the ``*_plain`` versions, the same functions in plain
    torch ops. Nothing on the card path calls them; ``chip_smoke.py`` holds
    the kernels against them on the card.

B5 and B6's dkdv and dq passes each have two kernels, chosen by
``on_tensor_cores``: bf16 runs the tensor-core kernels (maps up to 64x64),
whose forward and dq pass compute each query's relative logits by the same
product; the dq pass leaves them in an f32 scratch that the dkdv pass reads,
so dq runs first. f32, and bf16 maps past 64x64, run the CUDA-core kernels;
f32 is the card's reference route. A head past the largest width class runs
the kernels of ``csrc/attention_wide.cuh`` in chunks of its widths
(``fused_attention.width_plan``), whose dkdv pass reads the scratch on both
routes.

``HilAttention.apply`` is what a model calls: forward B5, backward B6's
three passes, returning (dP, dRw, dRh); building Rw / Rh from the embeddings
stays outside, under autograd, so dRw / dRh flow back to ``key_rel_w/h``.
The bare forward wrapper refuses CUDA operands that require grad while grad
mode is on: its output has no ``grad_fn``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops.fused_attention import (
    bwd_plan_args,
    fwd_plan_args,
    key_positions,
    key_table,
    on_tensor_cores,
    sm_count,
    width_library,
    width_plan,
)
from chexpert_tpu_torch.utils import trace

FWD = "hil_attention_fwd"
BWD_SOURCE = "hil_attention_bwd"  # one source, three kernels (passes)
BWD_DKDV = "hil_attention_bwd_dkdv"
BWD_DQ = "hil_attention_bwd_dq"
BWD_DREL = "hil_attention_bwd_drel"
BWD_PASSES = (BWD_DKDV, BWD_DQ, BWD_DREL)
DREL_THREADS = 128          # pass drel's least threads a block, where the batch allows
DREL_LANES = 32             # csrc/hil_attention_bwd.cu DREL_LANES: lanes of dkh a thread holds
DREL_SMEM_MAX = 64 * 1024   # csrc/hil_attention_bwd.cu DREL_SMEM_MAX
DREL_HEAD_SMEM = 48 * 1024  # the heads' partial sums alone (hsplit's limit)
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def hil_slot(dkh: int, dvh: int) -> int:
    """The model's slot stride: 2*dkh + dvh rounded up to a multiple of 8."""
    return -(-(2 * dkh + dvh) // 8) * 8


def hil_rel_operand(rel: torch.Tensor, n: int) -> torch.Tensor:
    """Rbd (n*dkh, n) with Rbd[(j, d), m] = rel[d, m - j + n - 1]: block j is
    the (dkh, n) window of the (dkh, 2n-1) embedding for query column / row
    j. An index of the parameter, so autograd scatters dRbd back onto it."""
    dkh = rel.shape[0]
    i = torch.arange(n, device=rel.device)
    win = rel[:, i[None, :] - i[:, None] + n - 1]  # (dkh, j, m)
    return win.permute(1, 0, 2).reshape(n * dkh, n)


def _geometry(P0, Rw, Rh, H: int, W: int, dkh: int, dvh: int, slot: int) -> int:
    """Validate the operands' shapes; returns nh."""
    if P0.dim() != 3 or P0.shape[1] != H * W:
        raise ValueError(f"P0 {tuple(P0.shape)} is not (B, H*W = {H * W}, nh*slot)")
    if slot < 2 * dkh + dvh or P0.shape[2] % slot:
        raise ValueError(f"slot {slot} must be >= 2*dkh + dvh = {2 * dkh + dvh} and divide "
                         f"P0's last dimension {P0.shape[2]}")
    if (Rw is None) != (Rh is None):
        raise ValueError("Rw and Rh are given together or not at all")
    if Rw is not None and (Rw.shape != (W * dkh, W) or Rh.shape != (H * dkh, H)):
        raise ValueError(f"Rw {tuple(Rw.shape)} / Rh {tuple(Rh.shape)} do not match "
                         f"H={H} W={W} dkh={dkh}")
    return P0.shape[2] // slot


def _unpack(P0, nh: int, dkh: int, dvh: int, slot: int):
    """f32 head-major views (B, nh, HW, .) of q, k, v."""
    B, hw, _ = P0.shape
    P = P0.float().view(B, hw, nh, slot).permute(0, 2, 1, 3)
    return P[..., :dkh], P[..., dkh:2 * dkh], P[..., 2 * dkh:2 * dkh + dvh]


def _heads(x, nh: int):
    """(B, HW, nh*d) -> f32 (B, nh, HW, d)."""
    B, hw, _ = x.shape
    return x.float().view(B, hw, nh, -1).permute(0, 2, 1, 3)


def _logits_plain(q, k, Rw, Rh, H: int, W: int) -> torch.Tensor:
    """f32 S = q.k^T + RC_w[:, col(j)] + RC_h[:, row(j)]; call with autocast off."""
    B, nh, hw, dkh = q.shape
    s = q @ k.transpose(-1, -2)
    if Rw is None:
        return s
    q2 = q.reshape(B, nh, H, W, dkh)
    rcw = torch.einsum("bnhwd,wdm->bnhwm", q2, Rw.float().view(W, dkh, W))
    rch = torch.einsum("bnhwd,hdm->bnhwm", q2, Rh.float().view(H, dkh, H))
    col, row = key_positions(hw, W, q.device)
    return s + rcw.reshape(B, nh, hw, W)[..., col] + rch.reshape(B, nh, hw, H)[..., row]


def hil_attention_fwd_plain(P0, Rw, Rh, H: int, W: int, dkh: int, dvh: int, slot: int):
    """Dense softmax in f32. Returns (out in P0's dtype, lse f32)."""
    nh = _geometry(P0, Rw, Rh, H, W, dkh, dvh, slot)
    B, hw, _ = P0.shape
    with torch.autocast(P0.device.type, enabled=False):
        q, k, v = _unpack(P0, nh, dkh, dvh, slot)
        s = _logits_plain(q, k, Rw, Rh, H, W)
        lse = torch.logsumexp(s, dim=-1)
        out = torch.exp(s - lse[..., None]) @ v
    return out.permute(0, 2, 1, 3).reshape(B, hw, nh * dvh).to(P0.dtype), lse


def hil_attention_delta(out: torch.Tensor, dout: torch.Tensor, nh: int) -> torch.Tensor:
    """delta = sum_dvh(dout * out) in f32, (B, nh, HW): B6's softmax
    correction (computed outside the kernel, as the JAX host side does)."""
    return (_heads(dout, nh) * _heads(out, nh)).sum(-1).contiguous()


def _ds_plain(P0, Rw, Rh, dout, lse, delta, H, W, dkh, dvh, slot):
    """(q, k, p, ds, do) in f32, head-major: p = exp(S - lse), ds = p (dout v^T - delta)."""
    nh = P0.shape[2] // slot
    q, k, v = _unpack(P0, nh, dkh, dvh, slot)
    do = _heads(dout, nh)
    p = torch.exp(_logits_plain(q, k, Rw, Rh, H, W) - lse[..., None])
    return q, k, p, p * (do @ v.transpose(-1, -2) - delta[..., None]), do


def hil_attention_bwd_dkdv_plain(P0, Rw, Rh, dout, lse, delta, H, W, dkh, dvh, slot):
    """Pass 1 of B6 in plain ops: f32 (dk, dv), head-major (B, nh, HW, .)."""
    with torch.autocast(P0.device.type, enabled=False):
        q, _, p, ds, do = _ds_plain(P0, Rw, Rh, dout, lse, delta, H, W, dkh, dvh, slot)
        return ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def hil_attention_bwd_dq_plain(P0, Rw, Rh, dout, lse, delta, H, W, dkh, dvh, slot):
    """Pass 2 of B6 in plain ops: f32 (dq (B, nh, HW, dkh), dRC (B, nh, HW,
    W+H) or None): the bins sum ds over the keys of one image column / row,
    and dq takes the relative logits' part from them."""
    with torch.autocast(P0.device.type, enabled=False):
        q, k, _, ds, _ = _ds_plain(P0, Rw, Rh, dout, lse, delta, H, W, dkh, dvh, slot)
        dq = ds @ k
        if Rw is None:
            return dq, None
        B, nh, hw, _ = q.shape
        ds4 = ds.reshape(B, nh, hw, H, W)  # key j = row * W + col
        dcw, dch = ds4.sum(3), ds4.sum(4)
        dq = dq + (torch.einsum("bnhwm,wdm->bnhwd", dcw.reshape(B, nh, H, W, W),
                                Rw.float().view(W, dkh, W))
                   + torch.einsum("bnhwm,hdm->bnhwd", dch.reshape(B, nh, H, W, H),
                                  Rh.float().view(H, dkh, H))).reshape(B, nh, hw, dkh)
        return dq, torch.cat([dcw, dch], dim=-1)


def hil_attention_bwd_drel_plain(P0, drc, H: int, W: int, dkh: int, slot: int):
    """Pass 3 of B6 in plain ops: f32 (dRw (W*dkh, W), dRh (H*dkh, H)) from q
    and the dRC rows of pass 2."""
    B, hw, width = P0.shape
    nh = width // slot
    with torch.autocast(P0.device.type, enabled=False):
        q2 = P0.float().view(B, hw, nh, slot)[..., :dkh].permute(0, 2, 1, 3).reshape(
            B, nh, H, W, dkh)
        d5 = drc.reshape(B, nh, H, W, W + H)
        dRw = torch.einsum("bnhwd,bnhwm->wdm", q2, d5[..., :W]).reshape(W * dkh, W)
        dRh = torch.einsum("bnhwd,bnhwm->hdm", q2, d5[..., W:]).reshape(H * dkh, H)
    return dRw, dRh


def hil_attention_bwd_plain(P0, Rw, Rh, out, lse, dout, H, W, dkh, dvh, slot):
    """The whole backward in plain ops: (dP in P0's dtype with every pad lane
    zero, dRw, dRh f32 or None)."""
    nh = _geometry(P0, Rw, Rh, H, W, dkh, dvh, slot)
    B, hw, _ = P0.shape
    delta = hil_attention_delta(out, dout, nh)
    args = (P0, Rw, Rh, dout, lse, delta, H, W, dkh, dvh, slot)
    dk, dv = hil_attention_bwd_dkdv_plain(*args)
    dq, drc = hil_attention_bwd_dq_plain(*args)
    pad = dq.new_zeros(B, nh, hw, slot - 2 * dkh - dvh)
    dP = torch.cat([dq, dk, dv, pad], dim=-1).permute(0, 2, 1, 3).reshape(B, hw, nh * slot)
    if Rw is None:
        return dP.to(P0.dtype), None, None
    return (dP.to(P0.dtype), *hil_attention_bwd_drel_plain(P0, drc, H, W, dkh, slot))


def _kernel_entry(name: str, source: str, operands, f32_operands, dkh: int, dvh: int,
                  W: int = 0, H: int = 0):
    """Validate what the kernels take and return the ctypes entry, in the
    library of the width class of (dkh, dvh) (``fused_attention.width_class``)."""
    P0 = operands[0]
    if P0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {P0.device}")
    dt = P0.dtype
    if dt not in _DTYPE_SUFFIX or any(t.dtype != dt for t in operands):
        raise ValueError(f"{name}: P0 / out / dout must share one dtype of "
                         f"{list(_DTYPE_SUFFIX)}, got {[t.dtype for t in operands]}")
    f32_operands = [t for t in f32_operands if t is not None]
    if any(t.dtype != torch.float32 for t in f32_operands):
        raise ValueError(f"{name}: Rw / Rh / lse / delta must be float32")
    if not all(t.is_contiguous() for t in (*operands, *f32_operands)):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.device != P0.device for t in (*operands, *f32_operands)):
        raise ValueError(f"{name}: all operands must be on one device")
    if P0.shape[0] > 65535 or W + H > 65535:
        raise ValueError(f"{name}: batch {P0.shape[0]} or W+H {W + H} exceeds the grid's limit")
    return getattr(width_library(name, source, dkh, dvh), f"{name}_{_DTYPE_SUFFIX[dt]}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def hil_attention_fwd(P0: torch.Tensor, Rw: Optional[torch.Tensor], Rh: Optional[torch.Tensor],
                      H: int, W: int, dkh: int, dvh: int,
                      slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: (out (B, HW, nh*dvh) in P0's dtype, lse (B, nh, HW) f32). Not
    differentiable on the card: use ``HilAttention.apply`` for training."""
    nh = _geometry(P0, Rw, Rh, H, W, dkh, dvh, slot)
    if P0.device.type == "cpu":
        return hil_attention_fwd_plain(P0, Rw, Rh, H, W, dkh, dvh, slot)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (P0, Rw, Rh)):
        raise RuntimeError(f"{FWD}: operands require grad but the raw kernel wrapper has no "
                           "backward; call HilAttention.apply (forward B5, backward B6)")
    B, hw, _ = P0.shape
    fn = _kernel_entry(FWD, FWD, (P0,), (Rw, Rh), dkh, dvh)
    out = torch.empty((B, hw, nh * dvh), dtype=P0.dtype, device=P0.device)
    lse = torch.empty((B, nh, hw), dtype=torch.float32, device=P0.device)
    plan = fwd_plan_args(P0.dtype, H, W, dkh, dvh, B * nh, sm_count(P0.device))
    tab = key_table(H, W, P0.device, max(plan[0], 1)) if on_tensor_cores(P0.dtype, H, W) else None
    kernels.launch(FWD, fn, [_ptr(t) for t in (P0, Rw, Rh, tab, out, lse)],
                   [B, hw, H, W, nh, slot, dkh, dvh, *width_plan(dkh, dvh)[1:], *plan],
                   P0.device)
    return out, lse


def _check_bwd(P0, nh: int, dvh: int, dout, lse, delta):
    B, hw, _ = P0.shape
    if dout.shape != (B, hw, nh * dvh) or lse.shape != (B, nh, hw) or delta.shape != lse.shape:
        raise ValueError(f"dout {tuple(dout.shape)} / lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} do not match P0 {tuple(P0.shape)}")


def _reads_rc(dtype, H: int, W: int, dkh: int, dvh: int) -> bool:
    """Whether pass 1 reads the queries' RC rows from the scratch of pass 2
    (with relative logits): on the tensor-core route, and for every head past
    the largest width class (``width_plan`` with more than one chunk)."""
    return on_tensor_cores(dtype, H, W) or width_plan(dkh, dvh)[1:] != (1, 1)


def hil_attention_bwd_dkdv(P0, Rw, Rh, dout, lse, delta, dP, H, W, dkh, dvh, slot,
                           rc=None) -> None:
    """Pass 1 of B6 on the card: writes the k, v and pad lanes of ``dP``. The
    tensor-core kernel (``on_tensor_cores``), and every kernel of a head past
    the largest width class, reads the queries' RC rows from ``rc``, the
    scratch that pass 2 returns, so pass 2 runs first."""
    nh = _geometry(P0, Rw, Rh, H, W, dkh, dvh, slot)
    _check_bwd(P0, nh, dvh, dout, lse, delta)
    if Rw is None or not _reads_rc(P0.dtype, H, W, dkh, dvh):
        rc = None
    elif rc is None or rc.shape != (P0.shape[0], nh, H * W, W + H):
        raise ValueError(f"{BWD_DKDV}: needs the RC scratch (B, nh, HW, W+H) of "
                         f"{BWD_DQ}, got {None if rc is None else tuple(rc.shape)}")
    fn = _kernel_entry(BWD_DKDV, BWD_SOURCE, (P0, dout, dP), (Rw, Rh, lse, delta, rc), dkh, dvh)
    kernels.launch(BWD_DKDV, fn, [_ptr(t) for t in (P0, Rw, Rh, dout, lse, delta, dP, rc)],
                   [P0.shape[0], H * W, H, W, nh, slot, dkh, dvh, *width_plan(dkh, dvh)[1:],
                    *bwd_plan_args("dkdv", P0.dtype, H, W, dkh, dvh, "hil")], P0.device)


def hil_attention_bwd_dq(P0, Rw, Rh, dout, lse, delta, dP, H, W, dkh, dvh, slot):
    """Pass 2 of B6 on the card: writes the q lanes of ``dP``; returns
    (dRC, RC), both (B, nh, HW, W+H) f32: the dRC rows that pass 3 reads (None
    without Rw) and the RC rows that pass 1 reads (None without Rw, or where
    the width class's CUDA-core kernels run)."""
    nh = _geometry(P0, Rw, Rh, H, W, dkh, dvh, slot)
    _check_bwd(P0, nh, dvh, dout, lse, delta)
    fn = _kernel_entry(BWD_DQ, BWD_SOURCE, (P0, dout, dP), (Rw, Rh, lse, delta), dkh, dvh)
    shape = (P0.shape[0], nh, H * W, W + H)
    drc = None if Rw is None else torch.empty(shape, dtype=torch.float32, device=P0.device)
    rc = (torch.empty(shape, dtype=torch.float32, device=P0.device)
          if Rw is not None and _reads_rc(P0.dtype, H, W, dkh, dvh) else None)
    plan = bwd_plan_args("dq", P0.dtype, H, W, dkh, dvh, "hil")
    tab = key_table(H, W, P0.device, max(plan[0], 1)) if on_tensor_cores(P0.dtype, H, W) else None
    kernels.launch(BWD_DQ, fn,
                   [_ptr(t) for t in (P0, Rw, Rh, dout, lse, delta, tab, dP, drc, rc)],
                   [P0.shape[0], H * W, H, W, nh, slot, dkh, dvh, *width_plan(dkh, dvh)[1:],
                    *plan], P0.device)
    return drc, rc


def drel_plan(B: int, H: int, W: int, nh: int, dkh: int) -> Tuple[int, int]:
    """(hsplit, bsplit) of pass drel (csrc/hil_attention_bwd.cu): a block
    has max(W, H) threads for each of hsplit shares of the heads and bsplit
    batch elements. hsplit takes every head that fits 1024 threads and
    DREL_HEAD_SMEM of partial sums; bsplit then grows until the block has
    DREL_THREADS threads, or the batch, 1024 threads or DREL_SMEM_MAX run
    out. The kernel writes one partial per group of bsplit batch elements."""
    n = max(W, H)
    dc = min(dkh, DREL_LANES)  # the lanes of dkh a block holds (DK)
    hsplit = min(1024 // n, nh)
    while hsplit > 1 and hsplit * dc * n * 4 > DREL_HEAD_SMEM:
        hsplit -= 1
    bsplit = 1
    while (n * hsplit * bsplit < DREL_THREADS and bsplit < B
           and n * hsplit * (bsplit + 1) <= 1024
           and (bsplit + 1) * hsplit * dc * n * 4 <= DREL_SMEM_MAX):
        bsplit += 1
    return hsplit, bsplit


def hil_attention_bwd_drel(P0, drc, H: int, W: int, dkh: int, slot: int, dvh: int = 1):
    """Pass 3 of B6 on the card: (dRw, dRh) f32; the kernel writes one
    partial per group of batch elements (``drel_plan``), summed here in a
    fixed order. ``dvh`` picks the library (the width class of the other
    passes); the kernel reads q and dRC alone."""
    B, hw, width = P0.shape
    nh = width // slot
    if drc.shape != (B, nh, hw, W + H):
        raise ValueError(f"dRC {tuple(drc.shape)} does not match P0 {tuple(P0.shape)}")
    fn = _kernel_entry(BWD_DREL, BWD_SOURCE, (P0,), (drc,), dkh, dvh, W, H)
    hsplit, bsplit = drel_plan(B, H, W, nh, dkh)
    part = torch.empty((-(-B // bsplit), dkh * (W * W + H * H)), dtype=torch.float32,
                       device=P0.device)
    kernels.launch(BWD_DREL, fn, [_ptr(t) for t in (P0, drc, part)],
                   [B, hw, H, W, nh, slot, dkh, width_plan(dkh, dvh)[1], hsplit, bsplit],
                   P0.device)
    dR = part.sum(0)
    return dR[:dkh * W * W].view(W * dkh, W), dR[dkh * W * W:].view(H * dkh, H)


def hil_attention_bwd(P0, Rw, Rh, out, lse, dout, H: int, W: int, dkh: int, dvh: int, slot: int):
    """B6: (dP in P0's dtype, dRw, dRh f32 or None), given the forward's out
    and lse and the output cotangent dout."""
    nh = _geometry(P0, Rw, Rh, H, W, dkh, dvh, slot)
    if P0.device.type == "cpu":
        return hil_attention_bwd_plain(P0, Rw, Rh, out, lse, dout, H, W, dkh, dvh, slot)
    if out.shape != dout.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} differ")
    delta = hil_attention_delta(out, dout, nh)
    dP = torch.empty_like(P0)  # every lane is written by exactly one pass
    args = (P0, Rw, Rh, dout, lse, delta, dP, H, W, dkh, dvh, slot)
    drc, rc = hil_attention_bwd_dq(*args)
    hil_attention_bwd_dkdv(*args, rc=rc)
    if Rw is None:
        return dP, None, None
    return (dP, *hil_attention_bwd_drel(P0, drc, H, W, dkh, slot, dvh))


class HilAttention(torch.autograd.Function):
    """out = softmax(S) v over the packed operand, forward B5 and backward
    B6 (plain versions for CPU tensors). The backward runs with autocast off
    and returns dP in P0's dtype and dRw / dRh in f32."""

    @staticmethod
    def forward(ctx, P0, Rw, Rh, H: int, W: int, dkh: int, dvh: int, slot: int):
        with trace.span("attn.fwd", H=H, W=W, heads=P0.shape[-1] // slot):
            out, lse = hil_attention_fwd(P0, Rw, Rh, H, W, dkh, dvh, slot)
        ctx.save_for_backward(P0, Rw, Rh, out, lse)
        ctx.geometry = (H, W, dkh, dvh, slot)
        return out

    @staticmethod
    def backward(ctx, dout):
        P0, Rw, Rh, out, lse = ctx.saved_tensors
        H, W, _, _, slot = ctx.geometry
        with torch.autocast(P0.device.type, enabled=False), \
                trace.span("attn.bwd", H=H, W=W, heads=P0.shape[-1] // slot):
            dP, dRw, dRh = hil_attention_bwd(P0, Rw, Rh, out, lse,
                                             dout.to(P0.dtype).contiguous(), *ctx.geometry)
        return dP, dRw, dRh, None, None, None, None, None


def aa_attention_hil_packed(P0: torch.Tensor, rel_w: Optional[torch.Tensor],
                            rel_h: Optional[torch.Tensor], H: int, W: int, dkh: int,
                            dvh: int, slot: int) -> torch.Tensor:
    """Attention over the packed projection output P0 (B, HW, nh*slot), with
    the raw (dkh, 2W-1) / (dkh, 2H-1) embeddings (None: no relative logits).
    Returns (B, HW, nh*dvh), whose view (B, H, W, dv) is out_proj's input."""
    if rel_w is None:
        Rw = Rh = None
    else:  # param-sized, f32, under autograd
        Rw = hil_rel_operand(rel_w.float(), W).contiguous()
        Rh = hil_rel_operand(rel_h.float(), H).contiguous()
    return HilAttention.apply(P0.contiguous(), Rw, Rh, H, W, dkh, dvh, slot)


def aa_attention_hil(q5: torch.Tensor, k5: torch.Tensor, v5: torch.Tensor,
                     rel_w: Optional[torch.Tensor], rel_h: Optional[torch.Tensor],
                     H: int, W: int, slot: Optional[int] = None) -> torch.Tensor:
    """The test surface: token-major q5 / k5 (B, HW, nh, dkh) and v5
    (B, HW, nh, dvh), q5 pre-scaled by dkh**-0.5, packed into zero-padded
    slots here (a model emits the packed channels from its projection and
    never runs this copy). Returns (B, HW, nh, dvh)."""
    B, hw, nh, dkh = q5.shape
    dvh = v5.shape[-1]
    slot = hil_slot(dkh, dvh) if slot is None else slot
    pad = q5.new_zeros(B, hw, nh, slot - 2 * dkh - dvh)
    P0 = torch.cat([q5, k5.to(q5.dtype), v5.to(q5.dtype), pad], dim=-1).reshape(B, hw, nh * slot)
    return aa_attention_hil_packed(P0, rel_w, rel_h, H, W, dkh, dvh, slot).reshape(
        B, hw, nh, dvh)
