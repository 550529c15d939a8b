"""Attention-augmented ResNet with Bottleneck blocks (ResNet, arXiv:1512.03385;
AA convs, arXiv:1904.09925), as the CheXpert reference repository builds
aaresnet152: a 7x7 stride-2 stem conv-BN-ReLU and a 3x3 stride-2 max pool,
four stages of ``layers`` Bottleneck blocks of widths 64, 128, 256, 512
(outputs four times as wide) and strides 1, 2, 2, 2, then global average
pool-linear. A Bottleneck block is 1x1 conv-BN-ReLU, 3x3 conv (stride in
the first block of a stage)-BN-ReLU, 1x1 conv-BN, added to the input
(through a 1x1 strided conv-BN where the shape changes), then ReLU. In
stages 2-4 the 3x3 conv is an AA conv over the block's width, its attention
on the strided map of size image_size * 16 / planes (40, 20 and 10 at
320x320).

Departures from arXiv:1512.03385, taken from the reference repository: the
AA convs (dk at least 20 a head, so 160 with 8 heads; dv a tenth of the
width), the stride on the 3x3 conv rather than the first 1x1 (torchvision's
"ResNet v1.5"), and a head of ``num_classes`` logits for multi-label BCE."""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.layers import aa_conv, aa_shapes, attn_dims, batch_norm, bn_shapes, conv2d, \
    linear

PLANES = (64, 128, 256, 512)
EXPANSION = 4
ROWS = 16  # rows of the batch an AA conv's attention runs on at a time


def blocks(cfg):
    """Per block: name, in channels, planes, stride, downsample, AA layer
    dict (dk, dv, nh, map, ...) or None."""
    a = cfg["attn"]
    out, cin = [], 64
    for li, (planes, n) in enumerate(zip(PLANES, cfg["layers"])):
        s = 1 if li == 0 else 2
        for i in range(n):
            stride = s if i == 0 else 1
            layer = None
            if li + 1 in a["stages"]:
                dk, dv = attn_dims(a["k"], a["v"], a["nh"], planes, a["min_dk_per_head"])
                size = int(cfg["image_size"] * 16 / planes)
                layer = {"dk": dk, "dv": dv, "nh": a["nh"], "map": (size, size),
                         "stride": stride, "kernel": 3, "relative": a["relative"]}
            c = cin if i == 0 else planes * EXPANSION
            out.append((f"layer{li + 1}.{i}", c, planes, stride,
                        i == 0 and (stride != 1 or c != planes * EXPANSION), layer))
        cin = planes * EXPANSION
    return out


def shapes(cfg):
    """name -> (shape, init kind) of every parameter and buffer. Each
    block's last BatchNorm scale (``bn3.weight``) starts at the
    configuration's ``init.branch_scale``: with it at 1 the 50 blocks of
    ResNet-152 amplify a rounding of their input so far that a float32 run
    and a bfloat16 run of this reference part as far as a float8 one does."""
    out = {"conv1.weight": ((64, 3, 7, 7), "conv")}
    out.update(bn_shapes("bn1", 64))
    for name, cin, planes, _, down, layer in blocks(cfg):
        out[name + ".conv1.weight"] = ((planes, cin, 1, 1), "conv")
        out.update(bn_shapes(name + ".bn1", planes))
        if layer is None:
            out[name + ".conv2.weight"] = ((planes, planes, 3, 3), "conv")
        else:
            out.update(aa_shapes(name + ".conv2", planes, planes, 3, layer))
        out.update(bn_shapes(name + ".bn2", planes))
        out[name + ".conv3.weight"] = ((planes * EXPANSION, planes, 1, 1), "conv")
        out.update(bn_shapes(name + ".bn3", planes * EXPANSION))
        out[name + ".bn3.weight"] = ((planes * EXPANSION,), cfg["init"]["branch_scale"])
        if down:
            out[name + ".downsample.0.weight"] = ((planes * EXPANSION, cin, 1, 1), "conv")
            out.update(bn_shapes(name + ".downsample.1", planes * EXPANSION))
    out["fc.weight"] = ((cfg["num_classes"], PLANES[-1] * EXPANSION), "linear")
    out["fc.bias"] = ((cfg["num_classes"],), "zeros")
    return out


def _stem(P, train, precision, x):
    x = conv2d(x, P["conv1.weight"], stride=2, padding=3, precision=precision)
    return F.max_pool2d(F.relu(batch_norm(x, P, "bn1", train)), 3, 2, 1)


def _aa(P, name, layer, precision, x):
    return aa_conv(x, P, name, layer, precision)


def _block(P, name, stride, down, layer, train, precision, x):
    y = F.relu(batch_norm(conv2d(x, P[name + ".conv1.weight"], precision=precision),
                          P, name + ".bn1", train))
    if layer is None:
        y = conv2d(y, P[name + ".conv2.weight"], stride=stride, padding=1, precision=precision)
    else:
        fn = partial(_aa, P, name + ".conv2", layer, precision)
        y = torch.cat([checkpoint(fn, rows, use_reentrant=False) for rows in y.split(ROWS)])
    y = F.relu(batch_norm(y, P, name + ".bn2", train))
    y = batch_norm(conv2d(y, P[name + ".conv3.weight"], precision=precision),
                   P, name + ".bn3", train)
    if down:
        x = batch_norm(conv2d(x, P[name + ".downsample.0.weight"], stride=stride,
                              precision=precision), P, name + ".downsample.1", train)
    return F.relu(y + x)


def forward(P, x, cfg, train: bool, precision: str = "f32"):
    """Logits (B, classes) of NCHW x.

    So that a training batch of the cell's size fits on one card, the stem
    and each block are recomputed in the backward from their inputs, and
    each AA conv, whose attention logits are (B, heads, HW, HW), runs
    ``ROWS`` rows at a time and is recomputed likewise; its operands' float8
    scales are then per block of rows. The result is the same as the plain
    forward's."""
    x = checkpoint(partial(_stem, P, train, precision), x, use_reentrant=False)
    for name, _, _, stride, down, layer in blocks(cfg):
        x = checkpoint(partial(_block, P, name, stride, down, layer, train, precision), x,
                       use_reentrant=False)
    x = x.mean(dim=(2, 3))
    return linear(x, P["fc.weight"], P["fc.bias"], precision)


def aa_layers(cfg):
    """(count per image, layer dict) of the AA convs' attention, for the
    FLOP counter and the kernels' bounds."""
    return [(1, layer) for *_, layer in blocks(cfg) if layer is not None]
