"""Train and eval steps (port of chexpert_tpu/train/steps.py).

The loss follows the reference hot loop (chexpert.py:156-165): BCE with
logits summed over classes, meaned over the batch. The forward runs under
``torch.autocast`` at the compute dtype with float32 parameters; the loss
is float32. The only random draws inside a step are the model's train-mode
ones (EfficientNet's DropConnect and Dropout), from ``state.generator``;
augmentation runs on the host (``device_augment`` of the packed input path
is ROADMAP.md slice 8).

In a multi-process run the train step calls the DistributedDataParallel
wrapper (``data_parallel``) on the rank's slice of the global batch: the
loss is the mean over that slice, and the slices are equal (train batches
drop the last partial one), so DDP's mean of the ranks' gradients is the
gradient of the global batch's mean loss.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD
from chexpert_tpu_torch.train.loss import bce_with_logits, train_loss
from chexpert_tpu_torch.train.state import TrainState


def prepare_image(x: torch.Tensor) -> torch.Tensor:
    """On-device input prep: (B, H, W, C) NHWC -> (B, 3, H, W) float32 NCHW.
    uint8 batches are scaled to [0, 1] and whitened; float batches arrive
    whitened; one channel is expanded to three."""
    if x.dtype == torch.uint8:
        x = (x.float() / 255.0 - PIXEL_MEAN) / PIXEL_STD
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    return x.permute(0, 3, 1, 2).contiguous()


def autocast(device: torch.device, dtype: torch.dtype):
    """torch.autocast at the compute dtype (off for float32)."""
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def rank_seed(seed: int, data_row: int, step: int = 0) -> int:
    """The seed of a rank's train-mode generator: ``seed`` on data row 0 (a
    one-process run's), else one drawn from (seed, data row, step), so the
    data rows draw different DropConnect and Dropout masks (``step``: the
    step a restored run resumes at). The ranks of one data row hold the same
    examples and draw the same masks."""
    if data_row == 0:
        return seed
    return int(np.random.SeedSequence((seed, data_row, step)).generate_state(1)[0])


def data_parallel(model: torch.nn.Module, device: torch.device) -> DistributedDataParallel:
    """The DistributedDataParallel wrapper of ``model`` over every rank.
    Buffers are not broadcast: the global BatchNorm (``parallel.sync_bn``)
    keeps the running statistics equal on every rank, and the ranks of one
    data row see the same examples."""
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               compute_dtype: torch.dtype) -> torch.Tensor:
    """One optimizer step on ``batch`` (tensors on the model's device);
    returns the loss as a 0-d tensor on the device (no host sync)."""
    model = (state.model if state.ddp is None else state.ddp).train()
    image = prepare_image(batch["image"])
    with autocast(image.device, compute_dtype):
        logits = model(image, generator=state.generator)
    loss = train_loss(logits, batch["label"], batch["mask"], batch.get("label_mask"))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return loss.detach()


@torch.no_grad()
def eval_logits(model: torch.nn.Module, image: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """f32 logits (B, C) of ``model`` in eval mode (running BN statistics)
    on a prepared (B, 3, H, W) image."""
    model.eval()
    with autocast(image.device, compute_dtype):
        return model(image).float()


def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits f32 (B, C), per-element BCE (B, C)) with running BN statistics."""
    out = eval_logits(state.model, prepare_image(batch["image"]), compute_dtype)
    return out, bce_with_logits(out, batch["label"])
