"""Optimizers and LR schedules with torch.optim, matching the JAX package's
optax ones (chexpert_tpu/train/optim.py):

  * Adam with torch defaults (betas .9/.999, eps 1e-8);
  * SGD, momentum .9, Nesterov (aadensenet121);
  * RMSprop, decay .99, momentum .9, eps 1e-3 outside the sqrt, in optax's
    order (``RMSpropLRInTrace``: the LR scales each step before the momentum
    trace, so the trace holds LR-scaled steps; ``torch.optim.RMSprop``
    multiplies the trace by the current LR instead, and the two part as
    soon as the LR changes);
  * 'hold' warmup: the LR stays at base until ``warmup_steps``, then the
    decay clock starts (reference chexpert.py:165); the CIFAR bench's
    'linear' warmup ramps from 0; multistep milestones, the staircase
    exponential decay and the cosine decay count from ``step - warmup_steps``;
  * weight decay as optax's ``add_decayed_weights`` ahead of the update.

``make_schedule`` is a pure function of the step; ``make_optimizer`` wraps it
in a ``LambdaLR`` stepped once per train step, so the LR of optimizer step
t (0-based) is ``schedule(t)``, as optax's count-indexed schedule gives.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch

from chexpert_tpu_torch.models.registry import OptimizerSpec


class RMSpropLRInTrace(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, momentum, eps_in_sqrt=False)``:
    nu = decay * nu + (1 - decay) * g^2;  u = g / (sqrt(nu) + eps);
    buf = momentum * buf + lr_t * u;  p -= buf. nu and buf start at 0, as
    ``scale_by_rms`` and ``trace`` have them. ``weight_decay`` adds
    weight_decay * p to g first (``optax.add_decayed_weights`` ahead of it)."""

    def __init__(self, params, lr: float, decay: float = 0.99, eps: float = 1e-3,
                 momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
                    self.state[p]["buf"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            bufs = [self.state[p]["buf"] for p in params]
            # each product rounded where optax rounds it
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - group["decay"])
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_add_(nus, sq)
            denom = torch._foreach_sqrt(nus)
            torch._foreach_add_(denom, group["eps"])
            scaled = torch._foreach_div(grads, denom)
            torch._foreach_mul_(scaled, group["lr"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, scaled)
            torch._foreach_sub_(params, bufs)
        return loss


def make_schedule(spec: OptimizerSpec, base_lr: float, warmup_steps: int = 0,
                  warmup_style: str = "hold",
                  cosine_decay_steps: Optional[int] = None) -> Callable:
    """The LR of optimizer step ``step`` (0-based). Before ``warmup_steps``
    it is ``base_lr`` ('hold') or ``base_lr * step / warmup_steps``
    ('linear', 0 at step 0); after, the schedule of ``spec`` on the clock
    ``step - warmup_steps``: constant, multistep (gamma 0.1), staircase
    exponential (``floor(eff / decay_steps)``) or cosine over
    ``cosine_decay_steps`` (then held at 0)."""
    if warmup_style not in ("hold", "linear"):
        raise ValueError(f"unknown warmup_style {warmup_style!r}")
    if spec.schedule == "cosine" and not cosine_decay_steps:
        raise ValueError("the cosine schedule needs cosine_decay_steps")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps if warmup_style == "linear" else base_lr
        eff = step - warmup_steps
        if spec.schedule == "constant":
            return base_lr
        if spec.schedule == "multistep":  # torch MultiStepLR, gamma 0.1
            return base_lr * 0.1 ** sum(eff >= m for m in spec.milestones)
        if spec.schedule == "exponential":  # staircase when decay_steps > 1
            return base_lr * spec.decay_factor ** math.floor(eff / spec.decay_steps)
        if spec.schedule == "cosine":
            return 0.5 * base_lr * (1.0 + math.cos(math.pi * min(eff / cosine_decay_steps, 1.0)))
        raise ValueError(f"unknown schedule {spec.schedule!r}")

    return schedule


def make_optimizer(spec: OptimizerSpec, params: Iterable[torch.nn.Parameter], base_lr: float,
                   warmup_steps: int = 0, warmup_style: str = "hold",
                   cosine_decay_steps: Optional[int] = None
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR, Callable]:
    """(optimizer, scheduler, schedule). ``spec.weight_decay`` is optax's
    ``add_decayed_weights`` ahead of the optimizer: ``wd * p`` added to every
    parameter's gradient (no mask) before the update. ``torch.optim.SGD``
    and ``torch.optim.Adam`` take it as their ``weight_decay``, which adds it
    at that place; ``RMSpropLRInTrace`` adds it itself, first."""
    schedule = make_schedule(spec, base_lr, warmup_steps, warmup_style, cosine_decay_steps)
    kw = {"lr": base_lr, "weight_decay": spec.weight_decay}
    if spec.kind == "adam":
        opt = torch.optim.Adam(params, **kw)
    elif spec.kind == "sgd_nesterov":
        opt = torch.optim.SGD(params, momentum=spec.momentum, nesterov=True, **kw)
    elif spec.kind == "rmsprop":
        opt = RMSpropLRInTrace(params, decay=0.99, eps=spec.eps, momentum=spec.momentum, **kw)
    else:
        raise ValueError(f"unknown optimizer {spec.kind!r}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: schedule(t) / base_lr if base_lr else 0.0)
    return opt, scheduler, schedule
