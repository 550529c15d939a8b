"""Train and eval steps (port of chexpert_tpu/train/steps.py, one device).

The loss follows the reference hot loop (chexpert.py:156-165): BCE with
logits summed over classes, meaned over the batch. The forward runs under
``torch.autocast`` at the compute dtype with float32 parameters; the loss
is float32. The only random draws inside a step are the model's train-mode
ones (EfficientNet's DropConnect and Dropout), from ``state.generator``;
augmentation runs on the host (``device_augment`` of the packed input path
is ROADMAP.md slice 8).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

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


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               compute_dtype: torch.dtype) -> torch.Tensor:
    """One optimizer step on ``batch`` (tensors on the model's device);
    returns the loss as a 0-d tensor on the device (no host sync)."""
    model = state.model.train()
    image = prepare_image(batch["image"])
    with _autocast(image.device, compute_dtype):
        logits = model(image, generator=state.generator)
    loss = train_loss(logits, batch["label"], batch["mask"], batch.get("label_mask"))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return loss.detach()


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits f32 (B, C), per-element BCE (B, C)) with running BN statistics."""
    model = state.model.eval()
    image = prepare_image(batch["image"])
    with _autocast(image.device, compute_dtype):
        out = model(image).float()
    return out, bce_with_logits(out, batch["label"])
