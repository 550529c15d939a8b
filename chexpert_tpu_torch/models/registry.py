"""Model factory, port of chexpert_tpu/models/registry.py for the archs this
port has (aadensenet121, densenet121, aadensenet-tiny, densenet-tiny).

``build_model`` returns the model alone, in float32 on ``device``,
initialized from ``generator`` (a fresh one seeded 0 when none is given).
``optimizer_spec(name)`` returns the per-arch optimizer / schedule choice
that the JAX factory returns beside its model (chexpert_tpu/models/
registry.py:28-38, 90-157):
  densenet121 and the tiny archs: Adam                      (chexpert.py:470)
  aadensenet121: SGD(momentum .9, nesterov) + MultiStep[40k, 60k]
                                                             (chexpert.py:479-480)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from chexpert_tpu_torch.models.densenet import AttnParams, DenseNet

N_CLASSES = 5
PORTED = ("densenet121", "aadensenet121", "densenet-tiny", "aadensenet-tiny")
# archs of the JAX registry that the port does not have yet (ROADMAP.md queue A)
_NOT_YET_PORTED = ("resnet152", "aaresnet152") + tuple(f"efficientnet-b{i}" for i in range(8))


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    kind: str  # 'adam' | 'sgd_nesterov' | 'rmsprop'
    schedule: str = "constant"  # 'constant' | 'multistep' | 'exponential'
    milestones: Tuple[int, ...] = ()
    decay_factor: float = 0.97
    decay_steps: int = 1  # staircase period for 'exponential'
    momentum: float = 0.9
    eps: float = 1e-3
    weight_decay: float = 0.0


def optimizer_spec(name: str) -> OptimizerSpec:
    if name == "aadensenet121":
        return OptimizerSpec("sgd_nesterov", "multistep", milestones=(40000, 60000))
    if name in PORTED:
        return OptimizerSpec("adam")
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to PyTorch yet; see ROADMAP.md for its slice")
    raise RuntimeError(f"Model architecture not supported: {name}")


def build_model(
    name: str,
    n_classes: int = N_CLASSES,
    image_size: int = 320,
    attn_impl: str = "pallas",
    prefix_stats: Optional[bool] = None,
    remat: bool = False,
    chunk_size: Optional[int] = None,
    slim_bwd: Optional[bool] = None,
    slim_block: Optional[bool] = None,
    concat_free: bool = False,
    device="cpu",
    generator: Optional[torch.Generator] = None,
) -> DenseNet:
    """``prefix_stats`` is accepted and has no effect: at eval the carried
    statistics are the running statistics, so it equals plain BatchNorm.
    ``remat``/``slim_bwd``/``slim_block``/``chunk_size``/``concat_free`` are
    TPU layout flags with nothing to do here and raise ValueError."""
    if remat or slim_bwd or slim_block or chunk_size or concat_free:
        raise ValueError("remat/slim_bwd/slim_block/chunk_size/concat_free are TPU "
                         "layout flags the PyTorch port does not take")
    if prefix_stats is not None and "densenet" not in name:
        raise ValueError(f"prefix_stats is only consumed by the DenseNet family, not {name!r}")
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to PyTorch yet; see ROADMAP.md for its slice")
    dims = (image_size, image_size)
    if name == "densenet121":
        model = DenseNet(32, (6, 12, 24, 16), 64, num_classes=n_classes)
    elif name == "aadensenet121":
        model = DenseNet(32, (6, 12, 24, 16), 64, num_classes=n_classes,
                         attn=AttnParams(0.2, 0.1, 8, True, dims), attn_impl=attn_impl)
    elif name == "densenet-tiny":
        model = DenseNet(8, (2, 2), 16, num_classes=n_classes)
    elif name == "aadensenet-tiny":
        model = DenseNet(8, (2, 2), 16, num_classes=n_classes,
                         attn=AttnParams(0.25, 0.25, 2, True, dims), attn_impl=attn_impl)
    else:
        raise RuntimeError(f"Model architecture not supported: {name}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(device)
