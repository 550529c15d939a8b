"""Losses (port of chexpert_tpu/train/loss.py).

Reference: BCEWithLogitsLoss(reduction='none') per class; the train loss
reduces .sum(1).mean(0) (reference chexpert.py:160, 530), with the batch
mean weighted by the validity mask so zero-padded rows do not bias it.
"""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element binary cross-entropy with logits, in f32:
    max(x, 0) - x*y + log(1 + exp(-|x|)), torch's formulation."""
    x = logits.float()
    y = targets.float()
    return torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))


def train_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
               label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over classes, mask-weighted mean over the batch; ``label_mask``
    (B, C) zeroes individual uncertain labels (U-Ignore)."""
    per_elem = bce_with_logits(logits, targets)
    if label_mask is not None:
        per_elem = per_elem * label_mask
    per_example = per_elem.sum(dim=1)
    return (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)
