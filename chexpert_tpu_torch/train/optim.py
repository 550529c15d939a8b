"""Optimizers and LR schedules with torch.optim, matching the JAX package's
optax ones (chexpert_tpu/train/optim.py):

  * Adam with torch defaults (betas .9/.999, eps 1e-8);
  * SGD, momentum .9, Nesterov (aadensenet121);
  * RMSprop, alpha .99, momentum .9, eps outside the sqrt, as torch has it;
  * 'hold' warmup: the LR stays at base until ``warmup_steps``, then the
    decay clock starts (reference chexpert.py:165); multistep milestones
    and the per-step exponential decay count from ``step - warmup_steps``.

``make_schedule`` is a pure function of the step; ``make_optimizer`` wraps it
in a ``LambdaLR`` stepped once per train step, so the LR of optimizer step
t (0-based) is ``schedule(t)``, as optax's count-indexed schedule gives.
The CIFAR bench's linear warmup and cosine decay come with it (ROADMAP.md
slice 8).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from chexpert_tpu_torch.models.registry import OptimizerSpec


def make_schedule(spec: OptimizerSpec, base_lr: float, warmup_steps: int = 0) -> Callable:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr
        eff = step - warmup_steps
        if spec.schedule == "constant":
            return base_lr
        if spec.schedule == "multistep":  # torch MultiStepLR, gamma 0.1
            return base_lr * 0.1 ** sum(eff >= m for m in spec.milestones)
        if spec.schedule == "exponential":  # staircase when decay_steps > 1
            return base_lr * spec.decay_factor ** math.floor(eff / spec.decay_steps)
        raise ValueError(f"unknown schedule {spec.schedule!r}")

    return schedule


def make_optimizer(spec: OptimizerSpec, params: Iterable[torch.nn.Parameter], base_lr: float,
                   warmup_steps: int = 0) -> Tuple[torch.optim.Optimizer,
                                                   torch.optim.lr_scheduler.LambdaLR, Callable]:
    """(optimizer, scheduler, schedule)."""
    schedule = make_schedule(spec, base_lr, warmup_steps)
    kw = {"lr": base_lr, "weight_decay": spec.weight_decay}
    if spec.kind == "adam":
        opt = torch.optim.Adam(params, **kw)
    elif spec.kind == "sgd_nesterov":
        opt = torch.optim.SGD(params, momentum=spec.momentum, nesterov=True, **kw)
    elif spec.kind == "rmsprop":
        opt = torch.optim.RMSprop(params, alpha=0.99, eps=spec.eps, momentum=spec.momentum,
                                  **kw)
    else:
        raise ValueError(f"unknown optimizer {spec.kind!r}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: schedule(t) / base_lr if base_lr else 0.0)
    return opt, scheduler, schedule
