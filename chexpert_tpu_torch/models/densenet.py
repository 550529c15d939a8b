"""DenseNet / attention-augmented DenseNet, NCHW.

Port of chexpert_tpu/models/densenet.py (eval semantics of its standard and
carried-stats paths, which are numerically equal):
  * ImageNet stem (4 dense blocks): conv0 7x7 s2 -> BN -> ReLU -> maxpool 3x3 s2
  * CIFAR stem (otherwise):         conv0 5x5 s1 -> BN -> ReLU
  * transitions: BN -> ReLU -> 1x1 conv (features//2) -> avgpool2   (standard)
                 InstanceNorm -> ReLU -> AAConv2d 3x3 s2            (AA variant)
  * head: norm5 -> ReLU -> global-avg-pool (f32) -> Linear (f32)

``forward(x, capture_weights=True)`` passes the flag to each AA transition
(``models/attn.py``). The Grad-CAM site (``gradcam_site``, read by
``interpret/gradcam.py``) is the ``features.norm5`` output, before the ReLU,
where the JAX model sows its ``gradcam_features``.

Module names follow torchvision (features.conv0 ... features.norm5,
classifier); the AA transition's tensors follow the JAX tree
(features.transitionN.conv.{in_proj_qkv,out_proj,conv}.weight, key_rel_{h,w}).
"""

from __future__ import annotations

import dataclasses
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
    InstanceNorm,
    conv,
    global_avg_pool,
    kaiming_normal_,
    torch_linear_,
)


@dataclasses.dataclass(frozen=True)
class AttnParams:
    k: float = 0.2
    v: float = 0.1
    nh: int = 8
    relative: bool = True
    input_dims: Tuple[int, int] = (320, 320)


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, bn_size: int):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_features)
        self.conv1 = conv(in_features, bn_size * growth_rate, 1)
        self.norm2 = nn.BatchNorm2d(bn_size * growth_rate)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class DenseBlock(nn.Sequential):
    def __init__(self, num_layers: int, in_features: int, growth_rate: int, bn_size: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(in_features + i * growth_rate, growth_rate, bn_size))


class Transition(nn.Module):
    """Standard (attn None) or attention-augmented transition."""

    def __init__(self, in_features: int, out_features: int, attn: Optional[AttnParams],
                 attn_map_dims: Optional[Tuple[int, int]], attn_impl: str,
                 attn_layout: str = "bn"):
        super().__init__()
        self.aa = attn is not None
        if not self.aa:
            self.norm = nn.BatchNorm2d(in_features)
            self.conv = conv(in_features, out_features, 1)
            return
        dk, dv = attn_dims(attn.k, attn.v, attn.nh, out_features)
        self.norm = InstanceNorm()
        self.conv = AAConv2d(in_features, out_features, 3, 2, dk, dv, attn.nh,
                             attn.relative, attn_map_dims, attn_impl=attn_impl,
                             attn_layout=attn_layout)

    def forward(self, x: torch.Tensor, capture_weights: bool = False) -> torch.Tensor:
        if self.aa:
            return self.conv(F.relu(self.norm(x)), capture_weights=capture_weights)
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    gradcam_site = "features.norm5"

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, num_classes: int = 5,
                 attn: Optional[AttnParams] = None, attn_impl: str = "pallas",
                 attn_layout: str = "bn"):
        super().__init__()
        check_attn_impl(attn_impl)
        check_attn_layout(attn_layout)
        self.imagenet_stem = len(block_config) == 4
        dims = None if attn is None else tuple(attn.input_dims)
        f = nn.Module()
        if self.imagenet_stem:
            f.conv0 = conv(3, num_init_features, 7, 2, padding=3)
            if dims is not None:
                dims = (dims[0] // 4, dims[1] // 4)
        else:
            f.conv0 = conv(3, num_init_features, 5, 1, padding=2)
        f.norm0 = nn.BatchNorm2d(num_init_features)
        num_features = num_init_features
        self.n_blocks = len(block_config)
        for i, num_layers in enumerate(block_config):
            setattr(f, f"denseblock{i + 1}",
                    DenseBlock(num_layers, num_features, growth_rate, bn_size))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                # the AA transition attends on the post-stride map: dims // 2
                tdims = None if dims is None else (dims[0] // 2, dims[1] // 2)
                setattr(f, f"transition{i + 1}",
                        Transition(num_features, num_features // 2, attn, tdims, attn_impl,
                                   attn_layout))
                num_features //= 2
            if dims is not None:
                dims = (dims[0] // 2, dims[1] // 2)
        f.norm5 = nn.BatchNorm2d(num_features)
        self.features = f
        self.classifier = nn.Linear(num_features, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: kaiming-normal
        (fan_in) convs, fan_out inside AAConv2d, BN scale 1 / bias 0 with
        running stats (0, 1), torch-default-style uniform linear weight and
        zero bias."""
        aa = [m for m in self.modules() if isinstance(m, AAConv2d)]
        aa_convs = {id(c) for m in aa for c in m.modules()}
        for m in aa:
            m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and id(m) not in aa_convs:
                kaiming_normal_(m.weight, "fan_in", generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        torch_linear_(self.classifier.weight, generator)
        self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                capture_weights: bool = False) -> torch.Tensor:
        del generator  # no random parts in this family
        f = self.features
        x = F.relu(f.norm0(f.conv0(x)))
        if self.imagenet_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_blocks):
            x = getattr(f, f"denseblock{i + 1}")(x)
            if i != self.n_blocks - 1:
                x = getattr(f, f"transition{i + 1}")(x, capture_weights=capture_weights)
        x = global_avg_pool(F.relu(f.norm5(x)))
        with torch.autocast(x.device.type, enabled=False):  # f32 head, as in JAX
            return self.classifier(x)
