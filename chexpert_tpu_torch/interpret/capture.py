"""Attention-weight capture with bounded memory (port of
chexpert_tpu/interpret/capture.py).

The visualization reruns the model with ``capture_weights=True``: each AA
conv takes the einsum route for that call and keeps its softmax weights
(``models/attn.py``). At 320x320 the first transition's weights are ~82 MB
f32 per image per layer, so the rerun is chunked over the batch and peak
memory is O(chunk). The tail chunk is zero-padded to the chunk's size, as
the JAX helper pads it to keep one compiled shape.

Layer order is the JAX package's: ``collect_attn_weights`` walks the sown
tree by sorted path names at each level, and ResNet blocks are named "0",
"1", ..., so ``layer3.10`` comes before ``layer3.2``. ``attention_layers``
sorts the port's module names (the same paths) the same way, so the two
lists match element by element.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from chexpert_tpu_torch.models.attn import AAConv2d
from chexpert_tpu_torch.train.steps import autocast


def attention_layers(model: torch.nn.Module) -> List[Tuple[str, AAConv2d]]:
    """(name, AA conv) pairs in the JAX package's order (sorted path names)."""
    layers = [(n, m) for n, m in model.named_modules() if isinstance(m, AAConv2d)]
    return sorted(layers, key=lambda nm: nm[0].split("."))


def capture_attention_weights(model: torch.nn.Module, x: torch.Tensor, chunk: int = 2,
                              compute_dtype: torch.dtype = torch.float32) -> List[np.ndarray]:
    """Per-layer softmax weights (B, nh, HW, HW) f32 for the input ``x``
    (B, 3, H, W), captured ``chunk`` images at a time; [] for a model with
    no attention layer."""
    layers = attention_layers(model)
    if not layers:
        return []
    n = x.shape[0]
    chunk = max(1, min(chunk, n))
    per_layer: List[List[np.ndarray]] = [[] for _ in layers]
    was_training = model.training
    try:
        for start in range(0, n, chunk):
            xb = x[start:start + chunk]
            valid = xb.shape[0]
            if valid < chunk:
                xb = torch.cat([xb, xb.new_zeros((chunk - valid,) + tuple(xb.shape[1:]))])
            with torch.no_grad(), autocast(x.device, compute_dtype):
                model.eval()(xb, capture_weights=True)
            for li, (_, m) in enumerate(layers):
                w, m.attn_weights = m.attn_weights, None
                per_layer[li].append(w[:valid].cpu().numpy())
    finally:
        for _, m in layers:
            m.attn_weights = None
        model.train(was_training)
    return [np.concatenate(parts) for parts in per_layer]
