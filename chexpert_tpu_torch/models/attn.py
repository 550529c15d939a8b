"""Attention-augmented convolution (AAConv2d), NCHW.

Port of chexpert_tpu/models/attn.py:
output = concat([conv(x) with out_channels-dv filters,
                 out_proj(multi-head rel-pos self-attention over H*W)], C).

``attn_impl``:
  * ``"pallas"`` and ``"pallas-<pack>"`` (every pack name the JAX side
    takes) route to the hand-written kernels, in the layout ``attn_layout``
    names;
  * ``"einsum"`` runs the plain reference math (``ops/attention.py``) and
    ignores the layout, as the JAX module does.
Any other string raises ValueError (no silent fall-through to a default).

``attn_layout`` (the JAX package's ``CHEXPERT_ATTN_LAYOUT``, read once by
``models.registry.build_model`` and passed down):
  * ``"bn"``: head-major operands (B*nh, HW, .) through
    ``ops/fused_attention.py::RelAttention`` (kernels B1 / B2) and the one
    query-side pack the port has; q, k, v are split into heads and the
    output merged back by data-sized copies;
  * ``"hil"``: heads-in-lanes, ``ops/hil_attention.py::HilAttention``
    (kernels B5 / B6). The 1x1 qkv projection runs as a matrix product over
    tokens whose weight rows are gathered into per-head [q ; k ; v ; 0-pad]
    slots (q rows scaled by dkh^-0.5), so its output IS the kernel operand,
    token-major, and the kernel's output, viewed (B, H, W, dv) and permuted,
    is a channels-last tensor that ``out_proj`` takes as it is. The
    parameter ``in_proj_qkv.weight`` keeps the checkpoint layout
    (2*dk+dv, Cin, 1, 1) on every route: the gather is a param-sized op
    under autograd. A geometry the kernels do not take raises; the layout
    never changes quietly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chexpert_tpu_torch.models.common import kaiming_normal_
from chexpert_tpu_torch.ops.attention import aa_attention_einsum, pack_query
from chexpert_tpu_torch.ops.fused_attention import RelAttention
from chexpert_tpu_torch.ops.hil_attention import aa_attention_hil_packed, hil_slot

REL_PACKS = ("fusedpack", "fusedpack5d", "bd", "einsum")
ATTN_IMPLS = ("einsum", "pallas") + tuple(f"pallas-{p}" for p in REL_PACKS)
ATTN_LAYOUTS = ("bn", "hil")


def attn_dims(k: float, v: float, nh: int, channels: int, min_dk_per_head: int = 20):
    """dk = max(20*nh, floor(k*channels/nh)*nh), dv = floor(v*channels/nh)*nh."""
    dk = max(min_dk_per_head * nh, int((k * channels // nh) * nh))
    dv = int((v * channels // nh) * nh)
    return dk, dv


def check_attn_impl(attn_impl: str) -> str:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of {ATTN_IMPLS}")
    return attn_impl


def check_attn_layout(attn_layout: str) -> str:
    if attn_layout not in ATTN_LAYOUTS:
        raise ValueError(f"attn_layout {attn_layout!r} is not one of {ATTN_LAYOUTS}")
    return attn_layout


class AAConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, strides: int,
                 dk: int, dv: int, nh: int, relative: bool, input_dims: Tuple[int, int],
                 attn_impl: str = "pallas", groups: int = 1, attn_layout: str = "bn"):
        super().__init__()
        if dk % nh or dv % nh:
            raise ValueError("nh must divide dk and dv")
        self.dk, self.dv, self.nh = dk, dv, nh
        self.strides = strides
        self.input_dims = tuple(input_dims)  # (H, W) of the attention map
        self.attn_impl = check_attn_impl(attn_impl)
        self.attn_layout = check_attn_layout(attn_layout)
        H, W = self.input_dims
        dkh, dvh = dk // nh, dv // nh
        # 1x1 qkv projection, stride applied here, no padding
        self.in_proj_qkv = nn.Conv2d(in_channels, 2 * dk + dv, 1, stride=strides, bias=False)
        if relative:
            self.key_rel_h = nn.Parameter(torch.empty(dkh, 2 * H - 1))
            self.key_rel_w = nn.Parameter(torch.empty(dkh, 2 * W - 1))
        else:
            self.key_rel_h = self.key_rel_w = None
        self.out_proj = nn.Conv2d(dv, dv, 1, bias=False)
        self.conv: Optional[nn.Conv2d] = (
            nn.Conv2d(in_channels, out_channels - dv, kernel_size, stride=strides,
                      padding=kernel_size // 2, groups=groups, bias=False)
            if out_channels > dv else None)
        # heads-in-lanes: projection rows in per-head [q_h ; k_h ; v_h] order
        # and the q rows' scale; not part of the state dict
        self.slot = hil_slot(dkh, dvh)
        rows, scale = [], []
        for h in range(nh):
            rows += range(h * dkh, (h + 1) * dkh)
            rows += range(dk + h * dkh, dk + (h + 1) * dkh)
            rows += range(2 * dk + h * dvh, 2 * dk + (h + 1) * dvh)
            scale += [dkh ** -0.5] * dkh + [1.0] * (dkh + dvh)
        self.register_buffer("_hil_rows", torch.tensor(rows), persistent=False)
        self.register_buffer("_hil_scale", torch.tensor(scale), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        kaiming_normal_(self.in_proj_qkv.weight, "fan_out", generator)
        kaiming_normal_(self.out_proj.weight, "fan_out", generator)
        if self.conv is not None:
            kaiming_normal_(self.conv.weight, "fan_out", generator)
        if self.key_rel_h is not None:
            for p in (self.key_rel_h, self.key_rel_w):  # dk^-0.5 + N(0, 1)
                p.normal_(0.0, 1.0, generator=generator).add_(self.dk ** -0.5)

    def packed_qkv_weight(self) -> torch.Tensor:
        """(nh*slot, Cin): the projection weight's rows gathered per head as
        [q_h * dkh^-0.5 ; k_h ; v_h] and zero rows up to the slot stride."""
        nh, slot = self.nh, self.slot
        w = self.in_proj_qkv.weight.flatten(1)
        w = w[self._hil_rows] * self._hil_scale[:, None]
        tight = w.shape[0] // nh
        return F.pad(w.view(nh, tight, -1), (0, 0, 0, slot - tight)).reshape(nh * slot, -1)

    def _attend_hil(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, Cin, Hin, Win) -> out_proj's input, (B, dv, H, W) in
        channels-last strides."""
        H, W = self.input_dims
        s = self.strides
        xs = x if s == 1 else x[:, :, ::s, ::s]
        B, cin, Hq, Wq = xs.shape
        if (Hq, Wq) != (H, W):
            raise ValueError(f"AAConv2d configured for {H}x{W} attention map, got {Hq}x{Wq}")
        # the 1x1 conv as a product over tokens: (B, HW, Cin) @ (Cin, nh*slot)
        # writes the token-major operand directly. reshape is a view of a
        # contiguous x at stride 1 and one copy of the subsampled input above.
        # When the weight requires grad, torch.matmul folds the batch into the
        # rows and copies the transposed tokens for it (its choice, to keep the
        # weight gradient one product); without grad it runs a batched product
        # on the view
        tokens = xs.reshape(B, cin, H * W).transpose(1, 2)
        P0 = torch.matmul(tokens, self.packed_qkv_weight().t())
        out = aa_attention_hil_packed(P0, self.key_rel_w, self.key_rel_h, H, W,
                                      self.dk // self.nh, self.dv // self.nh, self.slot)
        return out.view(B, H, W, self.dv).permute(0, 3, 1, 2)

    def _attend_heads(self, x: torch.Tensor) -> torch.Tensor:
        """Head-major routes (the bn layout's kernels, or einsum)."""
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
            out = RelAttention.apply(
                qr.reshape(B * nh, H * W, -1).contiguous(),
                kh.to(dt).reshape(B * nh, H * W, dkh).contiguous(),
                vh.to(dt).reshape(B * nh, H * W, dvh).contiguous(),
                H, W, dkh)
            attn = out.reshape(B, nh, H * W, dvh)
        # (B, nh, HW, dvh) -> (B, dv, H, W); inverse of to_heads
        return attn.transpose(2, 3).reshape(B, dv, H, W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attn_impl != "einsum" and self.attn_layout == "hil":
            attn = self._attend_hil(x)
        else:
            attn = self._attend_heads(x)
        attn = self.out_proj(attn)
        if self.conv is None:
            return attn
        return torch.cat([self.conv(x), attn], dim=1)
