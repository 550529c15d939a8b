"""The run state: the model (parameters and BatchNorm buffers), its
optimizer and LR scheduler, the global step, and the generator that the
train-mode random parts (EfficientNet's DropConnect and Dropout) draw from,
as one object that the train loop mutates and the checkpointer reads (the
JAX package's immutable TrainState pytree has no counterpart here; its
dropout key is folded from the seed and the step inside the step). In a
multi-process run ``ddp`` is the DistributedDataParallel wrapper of
``model`` that the train step calls; eval, checkpoints and every other
reader use ``model`` itself, so state-dict keys carry no ``module.``
prefix."""

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
    # on the model's device, seeded from the run's seed (and the rank's data
    # row, train.steps.rank_seed); None for a model without random parts
    generator: Optional[torch.Generator] = None
    # the train step's module in a multi-process run, else None
    ddp: Optional[torch.nn.Module] = None
