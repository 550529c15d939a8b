"""Attention-augmented WideResNet-d-w for CIFAR (WideResNet, arXiv:1605.07146;
AA convs, arXiv:1904.09925), as the reference repository's test-bench
builds it (models/attn_aug_conv.py:311-404): a 3x3 stem conv-BN-ReLU, three
stages of (d - 4) / 6 basic blocks of widths 16w, 32w, 64w and strides 1, 2,
2, and global average pool-linear. A basic block is conv-BN-ReLU-3x3
conv-BN, added to the input (through a 1x1 conv-BN where the shape
changes), then ReLU; in stages 2 and 3 its first conv is an AA conv whose
attention runs on the strided map, of size input * 16 / planes with the
input dims scaled by w. Departures from arXiv:1605.07146, taken from the
reference repository: post-activation blocks without dropout, and the AA
convs."""

from __future__ import annotations

import torch.nn.functional as F

from reference.layers import aa_conv, aa_shapes, attn_dims, batch_norm, bn_shapes, conv2d, \
    linear


def blocks(cfg):
    """Per block: name, in channels, planes, stride, downsample, AA layer
    dict or None."""
    depth, w = cfg["depth"], cfg["width"]
    n = (depth - 4) // 6
    a = cfg["attn"]
    dims = (cfg["image_size"] * w, cfg["image_size"] * w)
    out, cin = [], 16
    for li, (planes, s) in enumerate(zip((16 * w, 32 * w, 64 * w), (1, 2, 2))):
        for i in range(n):
            stride = s if i == 0 else 1
            layer = None
            if li > 0:
                dk, dv = attn_dims(a["k"], a["v"], a["nh"], planes, a["min_dk_per_head"])
                hw = (int(dims[0] * 16 / planes), int(dims[1] * 16 / planes))
                layer = {"dk": dk, "dv": dv, "nh": a["nh"], "map": hw, "stride": stride,
                         "kernel": 3, "relative": a["relative"]}
            out.append((f"layer{li + 1}.{i}", cin if i == 0 else planes, planes, stride,
                        i == 0 and (s != 1 or cin != planes), layer))
        cin = planes
    return out


def shapes(cfg):
    out = {"conv1.weight": ((16, 3, 3, 3), "conv")}
    out.update(bn_shapes("bn1", 16))
    planes = 16
    for name, cin, planes, _, down, layer in blocks(cfg):
        if layer is None:
            out[name + ".conv1.weight"] = ((planes, cin, 3, 3), "conv")
        else:
            out.update(aa_shapes(name + ".conv1", cin, planes, 3, layer))
        out.update(bn_shapes(name + ".bn1", planes))
        out[name + ".conv2.weight"] = ((planes, planes, 3, 3), "conv")
        out.update(bn_shapes(name + ".bn2", planes))
        if down:
            out[name + ".downsample.0.weight"] = ((planes, cin, 1, 1), "conv")
            out.update(bn_shapes(name + ".downsample.1", planes))
    out["fc.weight"] = ((cfg["num_classes"], planes), "linear")
    out["fc.bias"] = ((cfg["num_classes"],), "zeros")
    return out


def forward(P, x, cfg, train: bool, precision: str = "f32"):
    x = F.relu(batch_norm(conv2d(x, P["conv1.weight"], padding=1, precision=precision),
                          P, "bn1", train))
    for name, _, _, stride, down, layer in blocks(cfg):
        if layer is None:
            y = conv2d(x, P[name + ".conv1.weight"], stride=stride, padding=1,
                       precision=precision)
        else:
            y = aa_conv(x, P, name + ".conv1", layer, precision)
        y = F.relu(batch_norm(y, P, name + ".bn1", train))
        y = batch_norm(conv2d(y, P[name + ".conv2.weight"], padding=1, precision=precision),
                       P, name + ".bn2", train)
        if down:
            x = batch_norm(conv2d(x, P[name + ".downsample.0.weight"], stride=stride,
                                  precision=precision), P, name + ".downsample.1", train)
        x = F.relu(y + x)
    x = x.mean(dim=(2, 3))
    return linear(x, P["fc.weight"], P["fc.bias"], precision)


def aa_layers(cfg):
    return [(1, layer) for *_, layer in blocks(cfg) if layer is not None]
