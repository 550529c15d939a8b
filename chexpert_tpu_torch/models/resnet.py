"""ResNet and its attention-augmented variants, NCHW.

Port of chexpert_tpu/models/resnet.py (``BasicBlock``, ``Bottleneck``,
``ResNet``, ``WideResNet``):
  * BasicBlock: [conv3x3 s] -> BN -> ReLU -> conv3x3 -> BN (+identity) -> ReLU;
    the AA variant swaps the FIRST conv3x3 for AAConv2d
  * Bottleneck: conv1x1 -> BN -> ReLU -> [conv3x3 s] -> BN -> ReLU -> conv1x1
    -> BN (+identity) -> ReLU; the AA variant swaps the INNER conv3x3
  * ResNet: 7x7 s2 stem + maxpool 3x3 s2 + 4 layers, attention on layers 2-4
    only; resnet152 = Bottleneck (3, 8, 36, 3)
  * WideResNet-d-w (the CIFAR bench's): 3x3 s1 stem + 3 layers of
    BasicBlocks of width (16w, 32w, 64w), strides (1, 2, 2), n = (d - 4) / 6
    blocks each; attention on layers 2-3 with ``input_dims`` scaled by w, so
    that the 16 / planes rule gives the post-stride map (16x16 / 8x8 at 32x32)

An AA layer's attention map is input_dims * 16 / planes (40x40 / 20x20 /
10x10 on layers 2 / 3 / 4 at 320x320), already the post-stride size. With
the registry's AttnParams(k=0.2, v=0.1, nh=8) every bottleneck AA conv has
dk = 160 (20 per head) and dv = 8 / 24 / 48.

``forward(x, capture_weights=True)`` passes the flag through each stage
(``Stage``) and block to its AA conv (``models/attn.py``). The Grad-CAM site
(``gradcam_site``, read by ``interpret/gradcam.py``) is the ``layer4``
output, where the JAX model sows its ``gradcam_features``.

Module names are torchvision's (conv1, bn1, layerN.i.convK / bnK,
downsample.0 / .1, fc), so a ``.pth`` written by the JAX package's
``export_torch_state_dict`` loads strictly; an AA conv's tensors sit under
its conv's name (layer2.0.conv2.in_proj_qkv.weight, .key_rel_h, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chexpert_tpu_torch.models.attn import (
    AAConv2d,
    attn_dims,
    check_attn_impl,
    check_attn_layout,
)
from chexpert_tpu_torch.models.common import (
    conv,
    global_avg_pool,
    kaiming_normal_,
    torch_linear_,
)
from chexpert_tpu_torch.models.densenet import AttnParams


def _aa_layer_dims(attn: AttnParams, planes: int) -> Tuple[int, int]:
    """input_dims * 16 / planes."""
    return int(attn.input_dims[0] * 16 / planes), int(attn.input_dims[1] * 16 / planes)


def _aa_conv(in_ch: int, width: int, strides: int, attn: AttnParams, planes: int,
             attn_impl: str, attn_layout: str, groups: int = 1) -> AAConv2d:
    dk, dv = attn_dims(attn.k, attn.v, attn.nh, width)
    return AAConv2d(in_ch, width, 3, strides, dk, dv, attn.nh, attn.relative,
                    _aa_layer_dims(attn, planes), attn_impl=attn_impl, groups=groups,
                    attn_layout=attn_layout)


def _conv(conv: nn.Module, x: torch.Tensor, capture_weights: bool) -> torch.Tensor:
    """A block's conv, passing ``capture_weights`` to an AA conv."""
    return conv(x, capture_weights=capture_weights) if isinstance(conv, AAConv2d) else conv(x)


def _downsample(in_planes: int, out_planes: int, strides: int) -> nn.Sequential:
    return nn.Sequential(conv(in_planes, out_planes, 1, strides), nn.BatchNorm2d(out_planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, strides: int = 1,
                 has_downsample: bool = False, attn: Optional[AttnParams] = None,
                 attn_impl: str = "pallas", attn_layout: str = "bn"):
        super().__init__()
        self.conv1 = (conv(in_planes, planes, 3, strides) if attn is None else
                      _aa_conv(in_planes, planes, strides, attn, planes, attn_impl, attn_layout))
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _downsample(in_planes, planes, strides) if has_downsample else None

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor, capture_weights: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(self.conv1, x, capture_weights)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, strides: int = 1,
                 has_downsample: bool = False, attn: Optional[AttnParams] = None,
                 attn_impl: str = "pallas", attn_layout: str = "bn",
                 base_width: int = 64, groups: int = 1):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(in_planes, width, 1)
        self.bn1 = nn.BatchNorm2d(width)
        if attn is None:
            self.conv2 = nn.Conv2d(width, width, 3, stride=strides, padding=1, groups=groups,
                                   bias=False)
        else:  # dk / dv sized from the bottleneck width
            self.conv2 = _aa_conv(width, width, strides, attn, planes, attn_impl, attn_layout,
                                  groups)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = conv(width, planes * self.expansion, 1)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = (_downsample(in_planes, planes * self.expansion, strides)
                           if has_downsample else None)

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor, capture_weights: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(_conv(self.conv2, out, capture_weights)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Stage(nn.Sequential):
    """One ``layerN``: its blocks in turn, named "0", "1", ... as torchvision's."""

    def forward(self, x: torch.Tensor, capture_weights: bool = False) -> torch.Tensor:
        for block in self:
            x = block(x, capture_weights=capture_weights)
        return x


@torch.no_grad()
def reset_residual_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of a ResNet or WideResNet with the JAX package's
    initializers: kaiming-normal (fan_out) convs, AAConv2d's own, BN scale 1
    / bias 0 with running stats (0, 1) (the last BN of each residual branch
    scale 0 under ``zero_init_residual``), uniform linear weight and zero
    bias."""
    aa = [m for m in model.modules() if isinstance(m, AAConv2d)]
    aa_convs = {id(c) for m in aa for c in m.modules()}
    for m in aa:
        m.reset_parameters(generator)
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and id(m) not in aa_convs:
            kaiming_normal_(m.weight, "fan_out", generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    if model.zero_init_residual:
        for m in model.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                m.last_bn.weight.zero_()
    torch_linear_(model.fc.weight, generator)
    model.fc.bias.zero_()


class ResNet(nn.Module):
    """resnet50 (3, 4, 6, 3); resnet101 (3, 4, 23, 3); resnet152 (3, 8, 36, 3)."""

    gradcam_site = "layer4"

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 8, 36, 3),
                 num_classes: int = 5, attn: Optional[AttnParams] = None,
                 attn_impl: str = "pallas", attn_layout: str = "bn",
                 zero_init_residual: bool = False):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block {block!r} is not 'basic' or 'bottleneck'")
        check_attn_impl(attn_impl)
        check_attn_layout(attn_layout)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.zero_init_residual = zero_init_residual
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.bn1 = nn.BatchNorm2d(64)
        in_planes = 64
        # attention on layers 2-4 only
        for li, (planes, n, s) in enumerate(zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            needs_ds = s != 1 or in_planes != planes * block_cls.expansion
            blocks = []
            for i in range(n):
                blocks.append(block_cls(
                    in_planes if i == 0 else planes * block_cls.expansion, planes,
                    strides=s if i == 0 else 1, has_downsample=needs_ds and i == 0,
                    attn=None if li == 0 else attn, attn_impl=attn_impl,
                    attn_layout=attn_layout))
            setattr(self, f"layer{li + 1}", Stage(*blocks))
            in_planes = planes * block_cls.expansion
        self.fc = nn.Linear(in_planes, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_residual_parameters(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                capture_weights: bool = False) -> torch.Tensor:
        del generator  # no random parts in this family
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x, capture_weights=capture_weights)
        x = global_avg_pool(x)
        with torch.autocast(x.device.type, enabled=False):  # f32 head, as in JAX
            return self.fc(x)


class WideResNet(nn.Module):
    """WRN-depth-width; depth = 6n + 4."""

    gradcam_site = "layer3"

    def __init__(self, depth: int = 28, width: int = 10, num_classes: int = 100,
                 attn: Optional[AttnParams] = None, attn_impl: str = "pallas",
                 attn_layout: str = "bn", zero_init_residual: bool = False):
        super().__init__()
        if (depth - 4) % 6:
            raise AssertionError("depth should be 6n+4")
        check_attn_impl(attn_impl)
        check_attn_layout(attn_layout)
        n = (depth - 4) // 6
        if attn is not None:  # the 16 / planes rule, planes scaled by the width
            attn = AttnParams(attn.k, attn.v, attn.nh, attn.relative,
                              (attn.input_dims[0] * width, attn.input_dims[1] * width))
        self.zero_init_residual = zero_init_residual
        self.conv1 = conv(3, 16, 3, 1, padding=1)
        self.bn1 = nn.BatchNorm2d(16)
        in_planes = 16
        # attention on layers 2-3
        for li, (planes, s) in enumerate(zip((16 * width, 32 * width, 64 * width), (1, 2, 2))):
            blocks = [BasicBlock(in_planes if i == 0 else planes, planes,
                                 strides=s if i == 0 else 1,
                                 has_downsample=i == 0 and (s != 1 or in_planes != planes),
                                 attn=None if li == 0 else attn, attn_impl=attn_impl,
                                 attn_layout=attn_layout)
                      for i in range(n)]
            setattr(self, f"layer{li + 1}", Stage(*blocks))
            in_planes = planes
        self.fc = nn.Linear(in_planes, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_residual_parameters(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                capture_weights: bool = False) -> torch.Tensor:
        del generator  # no random parts in this family
        x = F.relu(self.bn1(self.conv1(x)))
        for layer in (self.layer1, self.layer2, self.layer3):
            x = layer(x, capture_weights=capture_weights)
        x = global_avg_pool(x)
        with torch.autocast(x.device.type, enabled=False):  # f32 head, as in JAX
            return self.fc(x)
