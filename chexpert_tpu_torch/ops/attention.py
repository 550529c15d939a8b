"""2-D relative-position multi-head spatial self-attention (plain torch ops).

Port of chexpert_tpu/ops/attention.py: the ground truth for the fused
kernel (``ops/fused_attention.py``), plus the query-side pack the kernel
consumes.

Key identity: the relative-width logit between query i=(ri, ci) and key
j=(rj, cj) is q_i . rel_w[cj - ci + W - 1] — it depends on j only through cj,
so the full (HW, HW) relative matrix is a broadcast of a compact (HW, W)
matrix over key rows plus a compact (HW, H) matrix over key columns.

Shapes: q, k of (B, nh, HW, dkh); v of (B, nh, HW, dvh); rel_w of
(dkh, 2W-1); rel_h of (dkh, 2H-1). q is pre-scaled by dkh**-0.5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _rel_abs(rel: torch.Tensor, n: int) -> torch.Tensor:
    """(dkh, 2n-1) -> (dkh, n, n) with out[d, a, b] = rel[d, b - a + n - 1]."""
    i = torch.arange(n, device=rel.device)
    return rel[:, i[None, :] - i[:, None] + n - 1]


def relative_logits_compact(
    q2d: torch.Tensor, rel_w: torch.Tensor, rel_h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact relative logits: q2d (B, nh, H, W, dkh) pre-scaled ->
    rw (B, nh, H*W, W) indexed by key column, rh (B, nh, H*W, H) by key row."""
    B, nh, H, W, _ = q2d.shape
    rw = torch.einsum("bnhwd,dwm->bnhwm", q2d, _rel_abs(rel_w, W))
    rh = torch.einsum("bnhwd,dhm->bnhwm", q2d, _rel_abs(rel_h, H))
    return rw.reshape(B, nh, H * W, W), rh.reshape(B, nh, H * W, H)


def relative_logits(
    q2d: torch.Tensor, rel_w: torch.Tensor, rel_h: torch.Tensor
) -> torch.Tensor:
    """Full (B, nh, HW, HW) relative-position logits."""
    B, nh, H, W, _ = q2d.shape
    rw, rh = relative_logits_compact(q2d, rel_w, rel_h)
    full = rw[:, :, :, None, :] + rh[:, :, :, :, None]  # (B, nh, HW, rj, cj)
    return full.reshape(B, nh, H * W, H * W)


def aa_attention_einsum(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_w: Optional[torch.Tensor],
    rel_h: Optional[torch.Tensor],
    H: int,
    W: int,
    return_weights: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reference-math attention. q pre-scaled. Returns (out, weights|None):
    out (B, nh, HW, dvh) in v's dtype, weights (B, nh, HW, HW) float32."""
    B, nh, hw, dkh = q.shape
    if hw != H * W:
        raise ValueError(f"hw={hw} != H*W={H}*{W}")
    # f32 logits and softmax from the operands' values, as the JAX path's
    # f32-accumulating einsums: autocast must not round them to bf16
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.einsum("bnid,bnjd->bnij", q.float(), k.float())
        if rel_w is not None:
            logits = logits + relative_logits(
                q.reshape(B, nh, H, W, dkh).float(), rel_w.float(), rel_h.float())
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bnij,bnjd->bnid", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype), (weights if return_weights else None)


def pack_query(
    q: torch.Tensor,
    rel_w: Optional[torch.Tensor],
    rel_h: Optional[torch.Tensor],
    H: int,
    W: int,
) -> torch.Tensor:
    """The kernel's query-side operand qr = [q ; RW ; RH] of
    (B, nh, HW, dkh+W+H) in q's dtype, or [q ; 0] when rel_w is None.

    One faithful pack of the JAX package's rel-pack variants (fusedpack, bd,
    einsum, ...), which are equal to each other by test."""
    B, nh, hw, dkh = q.shape
    if rel_w is None:
        return torch.cat([q, q.new_zeros(B, nh, hw, W + H)], dim=-1)
    rw, rh = relative_logits_compact(
        q.reshape(B, nh, H, W, dkh), rel_w.to(q.dtype), rel_h.to(q.dtype))
    return torch.cat([q, rw.to(q.dtype), rh.to(q.dtype)], dim=-1)
