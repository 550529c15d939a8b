"""Train and eval steps (port of chexpert_tpu/train/steps.py).

The loss follows the reference hot loop (chexpert.py:156-165): BCE with
logits summed over classes, meaned over the batch. The forward runs under
``torch.autocast`` at the compute dtype with float32 parameters; the loss
is float32. The random draws inside a step come from ``state.generator``:
the model's train-mode ones (EfficientNet's DropConnect and Dropout) and,
with ``device_crop`` (``--packed_cache --data_aug --device_aug``), the crop
offsets and flips of ``device_augment``.

In a multi-process run the train step calls the DistributedDataParallel
wrapper (``data_parallel``) on the rank's slice of the global batch: the
loss is the mean over that slice, and the slices are equal (train batches
drop the last partial one), so DDP's mean of the ranks' gradients is the
gradient of the global batch's mean loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD
from chexpert_tpu_torch.train.loss import bce_with_logits, train_loss
from chexpert_tpu_torch.train.state import TrainState
from chexpert_tpu_torch.utils import trace


def crop_and_flip(img: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                  flips: torch.Tensor, out_size: int) -> torch.Tensor:
    """Per image b of (B, S, S, C): the out_size x out_size window at
    (tops[b], lefts[b]), mirrored left-right where flips[b]; one gather."""
    B = img.shape[0]
    ar = torch.arange(out_size, device=img.device)
    rows = tops.to(img.device)[:, None] + ar
    cols = torch.where(flips.to(img.device)[:, None], out_size - 1 - ar, ar)
    cols = lefts.to(img.device)[:, None] + cols
    b = torch.arange(B, device=img.device)[:, None, None]
    return img[b, rows[:, :, None], cols[:, None, :]]


def device_augment(img: torch.Tensor, generator: Optional[torch.Generator],
                   out_size: int) -> torch.Tensor:
    """On-device random crop and horizontal flip of a batch of stored tiles
    (B, S, S, C) to (B, out_size, out_size, C): offsets uniform in [0, S -
    out_size] and flips with probability 1/2, drawn from ``generator`` on
    the batch's device (the JAX step draws them from its step key)."""
    B, S = img.shape[0], img.shape[1]
    margin = S - out_size
    kw = {"generator": generator, "device": img.device}
    tops = torch.randint(0, margin + 1, (B,), **kw)
    lefts = torch.randint(0, margin + 1, (B,), **kw)
    flips = torch.rand(B, **kw) < 0.5
    return crop_and_flip(img, tops, lefts, flips, out_size)


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
               compute_dtype: torch.dtype, device_crop: Optional[int] = None) -> torch.Tensor:
    """One optimizer step on ``batch`` (tensors on the model's device);
    returns the loss as a 0-d tensor on the device (no host sync). With
    ``device_crop``, stored tiles larger than it are cropped and flipped on
    the device first (``device_augment``). Spans: ``step`` around it all,
    then ``step.forward`` (the input's preparation on the device, the
    forward and the loss), ``step.backward`` and ``step.optimizer``
    (``utils/trace.py``)."""
    with trace.span(trace.STEP):
        model = (state.model if state.ddp is None else state.ddp).train()
        with trace.span("step.forward"):
            image = batch["image"]
            if device_crop is not None and image.shape[1] > device_crop:
                image = device_augment(image, state.generator, device_crop)
            image = prepare_image(image)
            with autocast(image.device, compute_dtype):
                logits = model(image, generator=state.generator)
            loss = train_loss(logits, batch["label"], batch["mask"], batch.get("label_mask"))
        with trace.span("step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with trace.span("step.optimizer"):
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
