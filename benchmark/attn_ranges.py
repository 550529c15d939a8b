"""Profiler ranges around the call that computes an AA conv's attention,
forward (``bench.attn.fwd``) and backward (``bench.attn.bwd``), opened
from the harness in traced runs only.

The program's AA conv looks its attention call up by name in
``chexpert_tpu_torch.models.attn`` at each call: ``RelAttention.apply``
(layout ``bn``) and ``aa_attention_hil_packed`` (layout ``hil``). The
harness puts a wrapper under each name. In the forward the wrapper holds a
range around the call; for the backward it threads the call's tensors
through two identity autograd functions, whose backwards run just before
and just after the attention's own, and which open and close the range.
The device time of the kernels launched inside the ranges is then the
attention's, whichever kernels the program uses.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

NAMES = ("bench.attn.fwd", "bench.attn.bwd")


class _Close(torch.autograd.Function):
    """Identity on the call's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, holder, *xs):
        ctx.holder = holder
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.holder:
            ctx.holder.pop().__exit__(None, None, None)
        return (None, *grads)


class _Open(torch.autograd.Function):
    """Identity on the call's output; its backward opens the range."""

    @staticmethod
    def forward(ctx, holder, out):
        ctx.holder = holder
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        rf = record_function(NAMES[1])
        rf.__enter__()
        ctx.holder.append(rf)
        return None, grad


def _ranged(fn, n_tensors: int):
    """fn(*args) with its first ``n_tensors`` arguments (tensors or None)
    inside the ranges."""

    def call(*args):
        tensors = [a for a in args[:n_tensors] if a is not None]
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
        holder = []
        if grad:
            it = iter(_Close.apply(holder, *tensors))
            args = tuple(a if a is None else next(it) for a in args[:n_tensors]) + \
                tuple(args[n_tensors:])
        with record_function(NAMES[0]):
            out = fn(*args)
        return _Open.apply(holder, out) if grad else out

    return call


class _Apply:
    def __init__(self, fn_cls):
        self.apply = _ranged(fn_cls.apply, 3)


def install():
    """Wrap the attention calls; returns a function that undoes it."""
    from chexpert_tpu_torch.models import attn

    saved = {"RelAttention": attn.RelAttention,
             "aa_attention_hil_packed": attn.aa_attention_hil_packed}
    attn.RelAttention = _Apply(saved["RelAttention"])
    attn.aa_attention_hil_packed = _ranged(saved["aa_attention_hil_packed"], 3)

    def undo():
        for k, v in saved.items():
            setattr(attn, k, v)

    return undo
