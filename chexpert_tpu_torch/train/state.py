"""The run state: the model (parameters and BatchNorm buffers), its
optimizer and LR scheduler, the global step, and the generator that the
train-mode random parts (EfficientNet's DropConnect and Dropout) draw from,
as one object that the train loop mutates and the checkpointer reads (the
JAX package's immutable TrainState pytree has no counterpart here; its
dropout key is folded from the seed and the step inside the step)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    # on the model's device, seeded from the run's seed; None for a model
    # without random parts
    generator: Optional[torch.Generator] = None
