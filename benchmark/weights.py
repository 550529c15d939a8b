"""Seeded weights of a configuration, made on the device in a few large
calls: one normal draw for every weight element from a generator on the
device, scaled per tensor by one foreach call; the constant tensors
filled. Init kinds (reference/layers.py ``*_shapes``): ``conv`` N(0,
2 / fan_in), ``linear`` N(0, 1 / fan_in), ``rel`` N(0, 1 / dkh), ``ones``,
``zeros``, ``count`` (an int64 0), or a number: the tensor filled with it."""

from __future__ import annotations

import math

import torch


def _std(shape, kind) -> float:
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind == "conv":
        return math.sqrt(2.0 / fan_in)
    if kind == "linear":
        return math.sqrt(1.0 / fan_in)
    if kind == "rel":
        return shape[0] ** -0.5
    raise ValueError(kind)


@torch.no_grad()
def make(shapes: dict, seed: int, device) -> dict:
    """name -> tensor (float32, int64 for ``count``) on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [(n, s, k) for n, (s, k) in shapes.items() if k in ("conv", "linear", "rel")]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=gen, device=device)
    views = list(torch.split(flat, [math.prod(s) for _, s, _ in drawn]))
    torch._foreach_mul_(views, [_std(s, k) for _, s, k in drawn])
    out = {n: v.view(s) for (n, s, _), v in zip(drawn, views)}
    for n, (s, k) in shapes.items():
        if k == "ones":
            out[n] = torch.ones(s, device=device)
        elif k == "zeros":
            out[n] = torch.zeros(s, device=device)
        elif k == "count":
            out[n] = torch.zeros(s, dtype=torch.long, device=device)
        elif isinstance(k, (int, float)):
            out[n] = torch.full(s, float(k), device=device)
    return {n: out[n] for n in shapes}
