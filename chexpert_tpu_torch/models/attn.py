"""Attention-augmented convolution (AAConv2d), NCHW.

Port of chexpert_tpu/models/attn.py on its head-major path:
output = concat([conv(x) with out_channels-dv filters,
                 out_proj(multi-head rel-pos self-attention over H*W)], C).

``attn_impl``:
  * ``"pallas"`` and ``"pallas-<pack>"`` (every pack name the JAX side
    takes) route to the hand-written kernel (``ops/fused_attention.py``)
    through the one query-side pack the port has;
  * ``"einsum"`` runs the plain reference math (``ops/attention.py``).
Any other string raises ValueError (no silent fall-through to a default).
The JAX heads-in-lanes layout (``CHEXPERT_ATTN_LAYOUT=hil``) is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from chexpert_tpu_torch.models.common import conv, kaiming_normal_
from chexpert_tpu_torch.ops.attention import aa_attention_einsum, pack_query
from chexpert_tpu_torch.ops.fused_attention import rel_attention_fwd

REL_PACKS = ("fusedpack", "fusedpack5d", "bd", "einsum")
ATTN_IMPLS = ("einsum", "pallas") + tuple(f"pallas-{p}" for p in REL_PACKS)


def attn_dims(k: float, v: float, nh: int, channels: int, min_dk_per_head: int = 20):
    """dk = max(20*nh, floor(k*channels/nh)*nh), dv = floor(v*channels/nh)*nh."""
    dk = max(min_dk_per_head * nh, int((k * channels // nh) * nh))
    dv = int((v * channels // nh) * nh)
    return dk, dv


def check_attn_impl(attn_impl: str) -> str:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of {ATTN_IMPLS}")
    return attn_impl


class AAConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, strides: int,
                 dk: int, dv: int, nh: int, relative: bool, input_dims: Tuple[int, int],
                 attn_impl: str = "pallas"):
        super().__init__()
        if dk % nh or dv % nh:
            raise ValueError("nh must divide dk and dv")
        self.dk, self.dv, self.nh = dk, dv, nh
        self.input_dims = tuple(input_dims)  # (H, W) of the attention map
        self.attn_impl = check_attn_impl(attn_impl)
        H, W = self.input_dims
        dkh = dk // nh
        # 1x1 qkv projection, stride applied here, no padding
        self.in_proj_qkv = nn.Conv2d(in_channels, 2 * dk + dv, 1, stride=strides, bias=False)
        if relative:
            self.key_rel_h = nn.Parameter(torch.empty(dkh, 2 * H - 1))
            self.key_rel_w = nn.Parameter(torch.empty(dkh, 2 * W - 1))
        else:
            self.key_rel_h = self.key_rel_w = None
        self.out_proj = nn.Conv2d(dv, dv, 1, bias=False)
        self.conv: Optional[nn.Conv2d] = (
            conv(in_channels, out_channels - dv, kernel_size, strides)
            if out_channels > dv else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        kaiming_normal_(self.in_proj_qkv.weight, "fan_out", generator)
        kaiming_normal_(self.out_proj.weight, "fan_out", generator)
        if self.conv is not None:
            kaiming_normal_(self.conv.weight, "fan_out", generator)
        if self.key_rel_h is not None:
            for p in (self.key_rel_h, self.key_rel_w):  # dk^-0.5 + N(0, 1)
                p.normal_(0.0, 1.0, generator=generator).add_(self.dk ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dk, dv, nh = self.dk, self.dv, self.nh
        dkh, dvh = dk // nh, dv // nh
        H, W = self.input_dims
        qkv = self.in_proj_qkv(x)
        B, _, Hq, Wq = qkv.shape
        if (Hq, Wq) != (H, W):
            raise ValueError(f"AAConv2d configured for {H}x{W} attention map, got {Hq}x{Wq}")

        # channel-major head split (c = h*dh + d): (B, nh*dh, H, W) -> (B, nh, HW, dh)
        def to_heads(t, dh):
            return t.reshape(B, nh, dh, H * W).transpose(2, 3)

        q, k, v = torch.split(qkv, [dk, dk, dv], dim=1)
        qh = to_heads(q, dkh) * (dkh ** -0.5)
        kh = to_heads(k, dkh)
        vh = to_heads(v, dvh)

        if self.attn_impl == "einsum":
            attn, _ = aa_attention_einsum(qh, kh, vh, self.key_rel_w, self.key_rel_h, H, W)
        else:
            qr = pack_query(qh, self.key_rel_w, self.key_rel_h, H, W)
            dt = qr.dtype
            out, _ = rel_attention_fwd(
                qr.reshape(B * nh, H * W, -1).contiguous(),
                kh.to(dt).reshape(B * nh, H * W, dkh).contiguous(),
                vh.to(dt).reshape(B * nh, H * W, dvh).contiguous(),
                H, W, dkh)
            attn = out.reshape(B, nh, H * W, dvh)

        # (B, nh, HW, dvh) -> (B, dv, H, W); inverse of to_heads
        attn = self.out_proj(attn.transpose(2, 3).reshape(B, dv, H, W))
        if self.conv is None:
            return attn
        return torch.cat([self.conv(x), attn], dim=1)
