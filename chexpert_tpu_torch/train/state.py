"""The run state: the model (parameters and BatchNorm buffers), its
optimizer and LR scheduler, and the global step, as one object that the
train loop mutates and the checkpointer reads (the JAX package's immutable
TrainState pytree has no counterpart here)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
