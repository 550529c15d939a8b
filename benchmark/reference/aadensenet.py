"""Attention-augmented DenseNet (DenseNet, arXiv:1608.06993; AA transitions,
arXiv:1904.09925), as the CheXpert reference repository builds it
(chexpert.py:474-480): the ImageNet stem, dense blocks of BN-ReLU-1x1
conv-BN-ReLU-3x3 conv layers concatenated to their input, transitions
InstanceNorm-ReLU-AA conv 3x3 stride 2 (attention over the strided map)
in place of BN-ReLU-1x1 conv-avgpool, and the head BN-ReLU-global average
pool-linear. Departure from arXiv:1608.06993, taken from the reference
repository: the transitions' attention augmentation and InstanceNorm.
``stem`` "cifar" (the small models' stem) is a 5x5 stride-1 conv-BN-ReLU
without the pool."""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.layers import aa_conv, aa_shapes, attn_dims, batch_norm, bn_shapes, conv2d, \
    instance_norm, linear


def _imagenet(cfg) -> bool:
    return cfg.get("stem", "imagenet") == "imagenet"


def transitions(cfg):
    """Per transition: name, in and out channels and its AA conv's layer
    dict (dk, dv, nh, map, ...), from the configuration's sizes."""
    a = cfg["attn"]
    # after the stride-2 conv and the stride-2 pool
    size = cfg["image_size"] // (4 if _imagenet(cfg) else 1)
    feats, out = cfg["num_init_features"], []
    for i, n in enumerate(cfg["block_config"][:-1]):
        feats += n * cfg["growth_rate"]
        size //= 2
        dk, dv = attn_dims(a["k"], a["v"], a["nh"], feats // 2, a["min_dk_per_head"])
        out.append((f"features.transition{i + 1}.conv", feats, feats // 2,
                    {"dk": dk, "dv": dv, "nh": a["nh"], "map": (size, size), "stride": 2,
                     "kernel": 3, "relative": a["relative"]}))
        feats //= 2
    return out


def shapes(cfg):
    """name -> (shape, init kind) of every parameter and buffer."""
    g, bn = cfg["growth_rate"], cfg["bn_size"]
    k = 7 if _imagenet(cfg) else 5
    out = {"features.conv0.weight": ((cfg["num_init_features"], 3, k, k), "conv")}
    out.update(bn_shapes("features.norm0", cfg["num_init_features"]))
    trans = transitions(cfg)
    feats = cfg["num_init_features"]
    for b, n in enumerate(cfg["block_config"]):
        for i in range(n):
            p = f"features.denseblock{b + 1}.denselayer{i + 1}"
            c = feats + i * g
            out.update(bn_shapes(p + ".norm1", c))
            out[p + ".conv1.weight"] = ((bn * g, c, 1, 1), "conv")
            out.update(bn_shapes(p + ".norm2", bn * g))
            out[p + ".conv2.weight"] = ((g, bn * g, 3, 3), "conv")
        feats += n * g
        if b < len(trans):
            name, cin, cout, layer = trans[b]
            out.update(aa_shapes(name, cin, cout, 3, layer))
            feats = cout
    out.update(bn_shapes("features.norm5", feats))
    out["classifier.weight"] = ((cfg["num_classes"], feats), "linear")
    out["classifier.bias"] = ((cfg["num_classes"],), "zeros")
    return out


ROWS = 16  # rows of the batch a transition's attention runs on at a time


def _dense_layer(P, p, train, precision, *feats):
    """One dense layer's new features from the block's features so far."""
    y = F.relu(batch_norm(torch.cat(feats, dim=1), P, p + ".norm1", train))
    y = conv2d(y, P[p + ".conv1.weight"], precision=precision)
    y = F.relu(batch_norm(y, P, p + ".norm2", train))
    return conv2d(y, P[p + ".conv2.weight"], padding=1, precision=precision)


def _transition(P, name, layer, precision, x):
    return aa_conv(F.relu(instance_norm(x)), P, name, layer, precision)


def forward(P, x, cfg, train: bool, precision: str = "f32"):
    """Logits (B, classes) of NCHW x.

    So that a training batch of CheXpert's size fits on one card, each dense
    layer is recomputed in the backward from the block's features (kept
    once, not concatenated anew for every layer), and each transition, whose
    attention logits are (B, heads, HW, HW), runs ``ROWS`` rows at a time
    and is recomputed likewise; its operands' float8 scales are then per
    block of rows. The result is the same as the plain forward's."""
    if _imagenet(cfg):
        x = conv2d(x, P["features.conv0.weight"], stride=2, padding=3, precision=precision)
    else:
        x = conv2d(x, P["features.conv0.weight"], padding=2, precision=precision)
    x = F.relu(batch_norm(x, P, "features.norm0", train))
    if _imagenet(cfg):
        x = F.max_pool2d(x, 3, 2, 1)
    trans = transitions(cfg)
    for b, n in enumerate(cfg["block_config"]):
        feats = [x]
        for i in range(n):
            p = f"features.denseblock{b + 1}.denselayer{i + 1}"
            feats.append(checkpoint(partial(_dense_layer, P, p, train, precision), *feats,
                                    use_reentrant=False))
        x = torch.cat(feats, dim=1)
        if b < len(trans):
            name, _, _, layer = trans[b]
            fn = partial(_transition, P, name, layer, precision)
            x = torch.cat([checkpoint(fn, rows, use_reentrant=False)
                           for rows in x.split(ROWS)], dim=0)
    x = F.relu(batch_norm(x, P, "features.norm5", train)).mean(dim=(2, 3))
    return linear(x, P["classifier.weight"], P["classifier.bias"], precision)


def aa_layers(cfg):
    """(count per image, layer dict) of the AA convs' attention, for the
    FLOP counter and the kernels' bounds."""
    return [(1, layer) for _, _, _, layer in transitions(cfg)]
