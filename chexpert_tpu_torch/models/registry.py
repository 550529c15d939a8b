"""Model factory, port of chexpert_tpu/models/registry.py: aadensenet121,
densenet121, aadensenet-tiny, densenet-tiny, resnet152, aaresnet152,
efficientnet-b0..b7.

``build_model`` returns the model alone, in float32 on ``device``,
initialized from ``generator`` (a fresh one seeded 0 when none is given).
``optimizer_spec(name)`` returns the per-arch optimizer / schedule choice
that the JAX factory returns beside its model (chexpert_tpu/models/
registry.py:28-38, 90-157):
  densenet121, resnet152, aaresnet152 and the tiny archs: Adam
                                                             (chexpert.py:470,485,494)
  aadensenet121: SGD(momentum .9, nesterov) + MultiStep[40k, 60k]
                                                             (chexpert.py:479-480)
  efficientnet-b*: RMSprop(momentum .9, eps 1e-3) + per-step exponential
                   decay gamma=lr_decay_factor               (chexpert.py:499-500)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
from torch import nn

from chexpert_tpu_torch.models.attn import check_attn_layout
from chexpert_tpu_torch.models.densenet import AttnParams, DenseNet
from chexpert_tpu_torch.models.efficientnet import SCALING_PARAMS, EfficientNet
from chexpert_tpu_torch.models.resnet import ResNet

N_CLASSES = 5
PORTED = ("densenet121", "aadensenet121", "densenet-tiny", "aadensenet-tiny",
          "resnet152", "aaresnet152", *SCALING_PARAMS)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    kind: str  # 'adam' | 'sgd_nesterov' | 'rmsprop'
    schedule: str = "constant"  # 'constant' | 'multistep' | 'exponential' | 'cosine'
    milestones: Tuple[int, ...] = ()
    decay_factor: float = 0.97
    decay_steps: int = 1  # staircase period for 'exponential'
    momentum: float = 0.9
    eps: float = 1e-3
    weight_decay: float = 0.0


def optimizer_spec(name: str) -> OptimizerSpec:
    if name == "aadensenet121":
        return OptimizerSpec("sgd_nesterov", "multistep", milestones=(40000, 60000))
    if name in SCALING_PARAMS:
        return OptimizerSpec("rmsprop", "exponential")
    if name in PORTED:
        return OptimizerSpec("adam")
    raise RuntimeError(f"Model architecture not supported: {name}")


def attn_layout_from_env() -> str:
    """The JAX package's attention layout switch, ``CHEXPERT_ATTN_LAYOUT``
    ("bn" by default; any other value than "bn" or "hil" raises)."""
    return check_attn_layout(os.environ.get("CHEXPERT_ATTN_LAYOUT", "bn"))


def build_model(
    name: str,
    n_classes: int = N_CLASSES,
    image_size: int = 320,
    attn_impl: str = "pallas",
    attn_layout: Optional[str] = None,
    dw_impl: str = "kernel",
    prefix_stats: Optional[bool] = None,
    remat: bool = False,
    chunk_size: Optional[int] = None,
    slim_bwd: Optional[bool] = None,
    slim_block: Optional[bool] = None,
    concat_free: bool = False,
    device="cpu",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """``attn_impl`` picks the attention route of the AA archs and
    ``attn_layout`` its kernels' layout, "bn" (head-major, B1 / B2) or "hil"
    (heads-in-lanes, B5 / B6); None reads the JAX package's switch
    ``CHEXPERT_ATTN_LAYOUT`` here, once (default "bn"), and any other value
    raises ValueError. ``dw_impl`` picks
    EfficientNet's depthwise route ("kernel" or "library"); ``image_size``
    sizes the attention maps (EfficientNet takes any size). ``prefix_stats``
    is accepted and has no effect: at eval the carried statistics are the
    running statistics, so it equals plain BatchNorm.
    ``remat``/``slim_bwd``/``slim_block``/``chunk_size``/``concat_free`` are
    TPU layout flags with nothing to do here and raise ValueError."""
    if remat or slim_bwd or slim_block or chunk_size or concat_free:
        raise ValueError("remat/slim_bwd/slim_block/chunk_size/concat_free are TPU "
                         "layout flags the PyTorch port does not take")
    if prefix_stats is not None and "densenet" not in name:
        raise ValueError(f"prefix_stats is only consumed by the DenseNet family, not {name!r}")
    if attn_layout is None:
        attn_layout = attn_layout_from_env()
    check_attn_layout(attn_layout)
    dims = (image_size, image_size)
    if name == "densenet121":
        model = DenseNet(32, (6, 12, 24, 16), 64, num_classes=n_classes)
    elif name == "aadensenet121":
        model = DenseNet(32, (6, 12, 24, 16), 64, num_classes=n_classes,
                         attn=AttnParams(0.2, 0.1, 8, True, dims), attn_impl=attn_impl,
                         attn_layout=attn_layout)
    elif name == "resnet152":
        model = ResNet("bottleneck", (3, 8, 36, 3), num_classes=n_classes)
    elif name == "aaresnet152":
        # every "pallas-<pack>" is the port's one query-side pack (the JAX
        # factory maps this arch's "pallas" to "pallas-bd", a TPU choice)
        model = ResNet("bottleneck", (3, 8, 36, 3), num_classes=n_classes,
                       attn=AttnParams(0.2, 0.1, 8, True, dims), attn_impl=attn_impl,
                       attn_layout=attn_layout)
    elif name == "densenet-tiny":
        model = DenseNet(8, (2, 2), 16, num_classes=n_classes)
    elif name == "aadensenet-tiny":
        model = DenseNet(8, (2, 2), 16, num_classes=n_classes,
                         attn=AttnParams(0.25, 0.25, 2, True, dims), attn_impl=attn_impl,
                         attn_layout=attn_layout)
    elif name in SCALING_PARAMS:
        model = EfficientNet(name, num_classes=n_classes, dw_impl=dw_impl)
    else:
        raise RuntimeError(f"Model architecture not supported: {name}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(device)
