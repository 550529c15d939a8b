"""Pieces shared by the training loops: the checked first steps, the timed
window, the per-layer counters and the reference's part."""

from __future__ import annotations

import contextlib
import gc
import math

import torch

from bounds.attention import step_bound_ms
from core import now
from devtrace import Profiler
from flops.model import train_flops


def host_copy(named) -> dict:
    return {n: t.detach().float().cpu().clone() for n, t in named}


def taken_gradient(model, optimizer):
    """(out, handle): a pre-hook of the optimizer's next step fills ``out``
    once with the gradient as the optimizer takes it, host copies by
    parameter name: each parameter's ``grad`` with ``weight_decay * p``
    added where its group's weight decay is not 0, as torch's SGD and Adam
    and the program's RMSprop add it first. The hook removes itself."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}

    def hook(opt, args, kwargs):
        handle.remove()
        for group in opt.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            grads = [p.grad for p in params]
            if group.get("weight_decay"):
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            out.update({names[id(p)]: g.detach().float().cpu().clone()
                        for p, g in zip(params, grads)})

    handle = optimizer.register_step_pre_hook(hook)
    return out, handle


def checked_steps(model, optimizer, step, n: int = 3) -> dict:
    """Run the program's first ``n`` steps through ``step()`` (which returns
    the loss tensor and the batch's row ids) and keep what the reference is
    compared with: the first step's logits (the model's output, read by a
    hook that is gone before the second step), each step's loss, the first
    step's gradient as the optimizer takes it (zeros where that step ran no
    optimizer step) and the parameters before and after."""
    p0 = host_copy(model.named_parameters())
    losses, rows, logits = [], [], []
    hook = model.register_forward_hook(lambda m, i, out: logits.append(out.detach().float().cpu()))
    taken, taking = taken_gradient(model, optimizer)
    for i in range(n):
        loss, row_ids = step()
        if i == 0:
            hook.remove()
            taking.remove()
        losses.append(float(loss))
        rows.append(row_ids)
    grad1 = {k: taken.get(k, torch.zeros(v.shape)) for k, v in p0.items()}
    return {"losses": losses, "rows": rows, "grad1": grad1, "p0": p0,
            "p3": host_copy(model.named_parameters()), "logits1": logits[0] if logits else None}


def ranged(traced: bool, name: str):
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def window(ctx, feed, step, batch: int, log_interval: int, trace_steps: int) -> dict:
    """Drive ``step(batch)`` over ``feed()`` for ``ctx.seconds``; the loss is
    read every ``log_interval`` steps. In a traced run the profiler covers
    ``trace_steps`` steps after the first, and the spans say which steps it
    covered."""
    rec, traced = ctx.record, ctx.trace
    prof = Profiler(traced, ctx.device)
    torch.cuda.synchronize(ctx.device) if ctx.device.type == "cuda" else None
    t0 = now()
    steps, nonfinite = 0, 0
    while True:
        if traced and steps == 1:
            prof.start(now)
        if prof.running and steps == 1 + trace_steps:
            prof.stop(now)
        profiled = prof.running
        a = now()
        with ranged(traced, "bench.input_wait"):
            b_ = feed()
        b = now()
        with ranged(traced, "bench.step"):
            loss = step(b_)
        c = now()
        rec.span("input.wait", a, b, profiled=profiled)
        rec.span("step.host", b, c, profiled=profiled)
        steps += 1
        if log_interval and steps % log_interval == 0:
            with ranged(traced, "bench.loss_read"):
                nonfinite += not math.isfinite(float(loss))
        if now() - t0 >= ctx.seconds:
            break
    prof.stop(now)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t1 = now()
    rec.counters.update(window_steps=steps, batch=batch,
                        profiled_steps=min(trace_steps, max(steps - 1, 0)) if traced else 0)
    return {"t0": t0, "t1": t1, "steps": steps, "nonfinite": nonfinite, "profiler": prof}


def finish(ctx, cell, ref, run: dict, batch: int, memory_peak: int) -> dict:
    """The end-to-end metrics and the traced run's counters."""
    rec = ctx.record
    if ctx.trace:
        rec.trace = run["profiler"].summary()
        rec.counters["train_flops_per_image"] = train_flops(ref, cell.config)
        rec.counters["attention_bound_ms_per_step"] = step_bound_ms(
            ref.aa_layers(cell.config), batch, cell.config["program"]["attn_layout"])
    seconds = run["t1"] - run["t0"]
    return {"metrics": {"img_per_s": run["steps"] * batch / seconds},
            "window_start": run["t0"], "attempted": run["steps"], "failed": run["nonfinite"],
            "memory_peak_bytes": memory_peak}


def release() -> None:
    """Return the freed program's device memory before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
