"""Shared building blocks (NCHW), port of chexpert_tpu/models/common.py.

Conventions:
  * parameters and running statistics in float32; reduced-precision compute
    comes from ``torch.autocast`` around the forward, as the JAX package keeps
    ``param_dtype=float32`` under a bfloat16 compute dtype;
  * torch-style symmetric explicit conv padding for the DenseNet family;
    EfficientNet pads as TF / XLA 'SAME' does (``same_padding``,
    ``pad_same``, ``SameConv2d``): on an even size with stride 2 the padding
    is asymmetric, more of it high, where torch's symmetric ``padding=``
    would shift the whole map by a pixel;
  * BatchNorm is torch's own (eps 1e-5, momentum 0.1 unless a family sets
    its own) and the pools are F.max_pool2d / F.avg_pool2d, whose padding
    already has torch semantics;
  * random init draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def conv(in_ch: int, out_ch: int, kernel_size: int, strides: int = 1,
         padding: Optional[int] = None) -> nn.Conv2d:
    """Bias-free nn.Conv2d with torch-style symmetric padding, kernel_size // 2
    by default (the JAX ``conv`` with ``torch_pad``)."""
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride=strides, bias=False,
                     padding=kernel_size // 2 if padding is None else padding)


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA / TF 'SAME' along a side of n: the total
    max((ceil(n/s) - 1) * s + k - n, 0), low half rounded down, the rest high."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero-pad the last two dims of NCHW x for a TF-SAME k x k conv."""
    top, bottom = same_padding(x.shape[-2], k, stride)
    left, right = same_padding(x.shape[-1], k, stride)
    return F.pad(x, (left, right, top, bottom))


class SameConv2d(nn.Conv2d):
    """Bias-free conv behind a TF-SAME zero pad (the JAX ``_same_conv``,
    flax ``nn.Conv(padding="SAME")``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(pad_same(x, self.kernel_size[0], self.stride[0]))


class InstanceNorm(nn.Module):
    """InstanceNorm2d with torch defaults: affine-free, biased variance,
    eps 1e-5, statistics computed in float32; returns the input's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, C), reduced in float32."""
    return x.float().mean(dim=(2, 3))


# --- seeded init (the JAX initializers' distributions) ----------------------

def _fans(w: torch.Tensor):
    receptive = math.prod(w.shape[2:]) if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive  # fan_in, fan_out


@torch.no_grad()
def kaiming_normal_(w: torch.Tensor, mode: str, generator: torch.Generator) -> torch.Tensor:
    """variance_scaling(2.0, mode, 'normal')."""
    fan_in, fan_out = _fans(w)
    std = math.sqrt(2.0 / (fan_in if mode == "fan_in" else fan_out))
    return w.normal_(0.0, std, generator=generator)


@torch.no_grad()
def torch_linear_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """variance_scaling(1/3, 'fan_in', 'uniform'): U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fans(w)[0])
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """variance_scaling(1.0, 'fan_in', 'truncated_normal'), flax's default
    conv init: a normal cut at two standard deviations, its scale raised so
    that the variance stays 1 / fan_in."""
    std = math.sqrt(1.0 / _fans(w)[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
