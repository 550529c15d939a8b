"""The FLOPs of a configuration's forward pass, counted from its shapes.

Convolutions and linear layers: ``torch.utils.flop_counter`` over the plain
reference's forward on the meta device (2 per multiply-add; no data, no
device). Attention: ``attention_flops`` per AA layer, the products the
published attention needs, each counted once: q.k and p.v over every
(query, key) pair and q against the W + H relative embeddings a query
uses. Training counts three forwards (the backward's two products per
forward product); nothing recomputed is counted.
"""

from __future__ import annotations

import torch

PRODUCT_OPS = ("convolution", "mm", "addmm")


def attention_flops(layer: dict) -> float:
    """One image's attention of an AA layer: nh * HW * (2 HW dkh + 2 HW dvh
    + 2 dkh (W + H))."""
    H, W = layer["map"]
    nh = layer["nh"]
    dkh, dvh = layer["dk"] // nh, layer["dv"] // nh
    hw = H * W
    rel = 2 * dkh * (W + H) if layer["relative"] else 0
    return nh * hw * (2 * hw * dkh + 2 * hw * dvh + rel)


def conv_linear_flops(ref, cfg, batch: int = 1) -> float:
    """Convolution and linear FLOPs of ``batch`` images through the reference."""
    from torch.utils.flop_counter import FlopCounterMode

    P = {n: torch.empty(s, device="meta") for n, (s, _) in ref.shapes(cfg).items()}
    x = torch.empty(batch, 3, cfg["image_size"], cfg["image_size"], device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(P, x, cfg, train=False)
    counts = counter.get_flop_counts()["Global"]
    return float(sum(v for op, v in counts.items()
                     if str(op).split(".")[-1] in PRODUCT_OPS))


def forward_flops(ref, cfg) -> float:
    """FLOPs of one image's forward."""
    return conv_linear_flops(ref, cfg) + sum(n * attention_flops(layer)
                                             for n, layer in ref.aa_layers(cfg))


def train_flops(ref, cfg) -> float:
    """FLOPs of one image's training step: three forwards."""
    return 3.0 * forward_flops(ref, cfg)
