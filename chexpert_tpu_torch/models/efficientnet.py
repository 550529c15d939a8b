"""EfficientNet-B0..B7, NCHW: port of chexpert_tpu/models/efficientnet.py.

Semantics carried over from the JAX modules (chexpert_tpu/models/
efficientnet.py:85-258): B0 base table and compound scaling as config math
(the port keeps its own copy of ``SCALING_PARAMS``, ``B0_BLOCKS``,
``round_filters`` and ``scaled_blocks``), TF-SAME padding (``SameConv2d``
for the stem, ``ops.depthwise.depthwise_conv2d`` for the depthwise convs),
BatchNorm eps 1e-3 / torch momentum 0.01, swish (``F.silu``), squeeze and
excitation (mean over H, W in f32, cast back; biased 1x1 reduce / expand;
``x * sigmoid(s)``), skip and DropConnect only when ``cin == cout`` and
stride 1, the per-stage drop-connect ramp ``rate * i / n``, a 1280-channel
head conv for every variant, head Dropout at the variant's rate and an f32
classifier outside autocast.

Module names equal the Flax names (``stem_conv``, ``stem_bn``,
``blocks_{si}_{i}.{expand_conv, expand_bn, depthwise_conv, depthwise_bn,
se.reduce, se.expand, project_conv, project_bn}``, ``head_conv``,
``head_bn``, ``classifier``), so a state dict written by the JAX
``export_torch_state_dict`` loads strictly.

The Grad-CAM site (``gradcam_site``, read by ``interpret/gradcam.py``) is
the ``head_bn`` output, before the swish, where the JAX model sows its
``gradcam_features``; ``forward`` takes ``capture_weights`` and ignores it
(no attention layers in this family), as the JAX module does.

``dw_impl`` picks the depthwise route: "kernel" (B3 forward / B4 backward
for every stride-1 layer) or "library" (the grouped conv everywhere, the
counterpart of ``CHEXPERT_DW=xla``). The train-mode random parts,
DropConnect and Dropout, draw from the ``generator`` passed to ``forward``
and from nothing else; in train mode with a rate above 0 and no generator
they raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chexpert_tpu_torch.models.common import (
    SameConv2d,
    global_avg_pool,
    kaiming_normal_,
    lecun_normal_,
    torch_linear_,
)
from chexpert_tpu_torch.ops.depthwise import IMPLS, depthwise_conv2d

# (width_coefficient, depth_coefficient, resolution, dropout_rate)
SCALING_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}

# (n_repeats, in_channels, out_channels, kernel_size, stride, expand_ratio, se_ratio)
B0_BLOCKS = (
    (1, 32, 16, 3, 1, 1, 0.25),
    (2, 16, 24, 3, 2, 6, 0.25),
    (2, 24, 40, 5, 2, 6, 0.25),
    (3, 40, 80, 3, 2, 6, 0.25),
    (3, 80, 112, 5, 1, 6, 0.25),
    (4, 112, 192, 5, 2, 6, 0.25),
    (1, 192, 320, 3, 1, 6, 0.25),
)
HEAD_CHANNELS = 1280


def round_filters(filters: int, width_coeff: float, depth_divisor: int = 8) -> int:
    new_filters = max(
        depth_divisor,
        int(filters * width_coeff + depth_divisor / 2) // depth_divisor * depth_divisor,
    )
    if new_filters < 0.9 * (filters * width_coeff):
        new_filters += depth_divisor
    return int(new_filters)


def scaled_blocks(model_name: str):
    """(stem channels, scaled block table, dropout rate) of a variant."""
    width_coeff, depth_coeff, _res, dropout_rate = SCALING_PARAMS[model_name]
    blocks = tuple(
        (int(math.ceil(depth_coeff * n)), round_filters(cin, width_coeff),
         round_filters(cout, width_coeff), k, s, e, se)
        for n, cin, cout, k, s, e, se in B0_BLOCKS)
    return round_filters(32, width_coeff), blocks, dropout_rate


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-3, momentum=0.01)


def _keep_mask(shape, rate: float, x: torch.Tensor,
               generator: Optional[torch.Generator], what: str) -> torch.Tensor:
    if generator is None:
        raise ValueError(f"{what} in train mode draws from an explicit torch.Generator; "
                         "pass generator= to the model's forward")
    return torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate


def drop_connect(x: torch.Tensor, rate: float, training: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: zero whole samples with probability ``rate``, scale
    the survivors by 1 / (1 - rate)."""
    if not training or rate == 0.0:
        return x
    keep = _keep_mask((x.shape[0], 1, 1, 1), rate, x, generator, "DropConnect")
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout (flax ``nn.Dropout``) drawing from ``generator``."""
    if not training or rate == 0.0:
        return x
    keep = _keep_mask(x.shape, rate, x, generator, "Dropout")
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class DepthwiseConv(nn.Module):
    """TF-SAME depthwise conv, parameter ``weight`` (C, 1, k, k): B3 / B4 for
    stride 1 with ``dw_impl="kernel"``, the grouped conv otherwise."""

    def __init__(self, channels: int, kernel_size: int, stride: int, dw_impl: str = "kernel"):
        super().__init__()
        self.stride = stride
        self.dw_impl = dw_impl
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv2d(x, self.weight, self.stride, self.dw_impl)


class SELayer(nn.Module):
    def __init__(self, channels: int, reduce_channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, reduce_channels, 1)
        self.expand = nn.Conv2d(reduce_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConvBlock(nn.Module):
    """Mobile inverted residual bottleneck."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 expand_ratio: int, se_ratio: float, drop_connect_rate: float, dw_impl: str):
        super().__init__()
        expand = int(in_channels * expand_ratio)
        self.expands = expand_ratio != 1
        if self.expands:
            self.expand_conv = nn.Conv2d(in_channels, expand, 1, bias=False)
            self.expand_bn = _bn(expand)
        self.depthwise_conv = DepthwiseConv(expand, kernel_size, stride, dw_impl)
        self.depthwise_bn = _bn(expand)
        self.se = SELayer(expand, max(1, int(in_channels * se_ratio)))
        self.project_conv = nn.Conv2d(expand, out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)
        self.skip = in_channels == out_channels and stride == 1
        self.drop_connect_rate = drop_connect_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inp = x
        if self.expands:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.depthwise_bn(self.depthwise_conv(x)))
        x = self.project_bn(self.project_conv(self.se(x)))
        if self.skip:
            x = drop_connect(x, self.drop_connect_rate, self.training, generator) + inp
        return x


class EfficientNet(nn.Module):
    """Any of efficientnet-b0..b7 via ``model_name``."""

    gradcam_site = "head_bn"

    def __init__(self, model_name: str = "efficientnet-b0", num_classes: int = 5,
                 drop_connect_rate: float = 0.2, dw_impl: str = "kernel"):
        super().__init__()
        if dw_impl not in IMPLS:
            raise ValueError(f"dw_impl must be one of {IMPLS}, got {dw_impl!r}")
        stem, blocks, self.dropout_rate = scaled_blocks(model_name)
        self.stem_conv = SameConv2d(3, stem, 3, 2)
        self.stem_bn = _bn(stem)
        self.block_names = []
        for si, (n, cin, cout, k, s, e, se) in enumerate(blocks):
            for i in range(n):
                name = f"blocks_{si}_{i}"
                setattr(self, name, MBConvBlock(
                    cin if i == 0 else cout, cout, k, s if i == 0 else 1, e, se,
                    drop_connect_rate * i / n, dw_impl))
                self.block_names.append(name)
        self.head_conv = nn.Conv2d(blocks[-1][2], HEAD_CHANNELS, 1, bias=False)
        self.head_bn = _bn(HEAD_CHANNELS)
        self.classifier = nn.Linear(HEAD_CHANNELS, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX initializers: variance_scaling(2, fan_out,
        normal) for the convs (the depthwise kernel's fan_out is C * k * k, as
        flax counts its (k, k, 1, C) kernel), flax's default lecun_normal and
        zero bias for the SE convs, BN scale 1 / bias 0 with running stats
        (0, 1), the torch-default-style uniform classifier with zero bias."""
        se_convs = {id(c) for m in self.modules() if isinstance(m, SELayer)
                    for c in (m.reduce, m.expand)}
        for m in self.modules():
            if id(m) in se_convs:
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, DepthwiseConv)):
                kaiming_normal_(m.weight, "fan_out", generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        torch_linear_(self.classifier.weight, generator)
        self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                capture_weights: bool = False) -> torch.Tensor:
        del capture_weights  # no attention layers in this family
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x, generator)
        x = F.silu(self.head_bn(self.head_conv(x)))
        x = dropout(global_avg_pool(x), self.dropout_rate, self.training, generator)
        with torch.autocast(x.device.type, enabled=False):  # f32 head, as in JAX
            return self.classifier(x)
