"""The comparison that decides ``correct``: the program's outputs on the
timed path against the plain reference, number by number, each beside its
limit (``limits/<cell>.json``).

Training: set-up drives the program's train step through its first three
steps on the window's own feed; the reference follows them from the same
weights and the same generated inputs, which it decodes and prepares
itself, under the optimizer the configuration names. Read: the first
step's logits; each step's loss; the first gradient as the optimizer
takes it (weight decay added); and the parameters' change after the three
steps. A leaf's gap is the gap between the two norms, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
The change's difference (``change_diff_median``) is the norm of the two
changes' difference over the reference change's norm: it sees a change of
the right norm in the wrong direction, as Adam's first steps, which move
each element by about lr, can make. Leaves whose reference gradient is
under a thousandth of the median leaf's are round-off on both sides and
are left out of the gradient's and the change's readings. Which readings
have a limit is the cell's ``limits/<cell>.json``; PERF.md gives the
readings each was set from.

Serving: every answer of the window against the reference's probabilities
for the JPEG that was sent; an answer that never came counts as missing.
"""

from __future__ import annotations

import statistics
import sys

import torch

ZERO_GRAD = 1e-3  # a leaf's reference gradient under this share of the median leaf's


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap: the gap between its two norms, relative to the larger
    of its reference norm and the median leaf's."""
    pn, rn = _norms({k: prog[k] for k in ref}), _norms(ref)
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in ref}


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"logits1": the first step's (B, classes), "losses": [3
    floats], "grad1": {leaf: tensor}, "p0": ..., "p3": ...}. The readings:
    logit_gap (the first step's logits, the L2 norm of the difference over
    the reference's; 1 where the rows differ), the losses' relative gaps,
    and per leaf the gaps of the first gradient and of the change, as the
    worst leaf's and the median leaf's (``*_median``), the worst named, and
    the median leaf's difference of the changes over the reference's
    change."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    moved = [k for k in ref["p3"] if gn[k] >= ZERO_GRAD * med]
    grad = leaf_gaps({k: prog["grad1"][k] for k in moved}, {k: ref["grad1"][k] for k in moved})
    dp = {k: prog["p3"][k].double().cpu() - prog["p0"][k].double().cpu() for k in moved}
    dr = {k: ref["p3"][k].double().cpu() - ref["p0"][k].double().cpu() for k in moved}
    change = leaf_gaps(dp, dr)
    diff = [float((dp[k] - dr[k]).norm() / dr[k].norm().clamp(min=1e-30)) for k in moved]
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    zp, zr = prog.get("logits1"), ref["logits1"]
    same = zp is not None and zp.shape == zr.shape
    d = (zp.double() - zr.double()) if same else None
    logit_gap = float(d.norm() / zr.double().norm()) if same else 1.0
    logit_rms = float(d.pow(2).mean().sqrt()) if same else float("inf")
    return {"logit_gap": logit_gap, "logit_rms": logit_rms,
            "loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": grad[worst_g], "grad_gap_median": statistics.median(grad.values()),
            "change_gap": change[worst_c],
            "change_gap_median": statistics.median(change.values()),
            "change_diff_median": statistics.median(diff),
            "leaves": {"grad": worst_g, "change": worst_c,
                       "left_out": sorted(set(ref["p3"]) - set(moved))}}


def reference_train(ref_mod, cfg, weights: dict, batches, loss_fn, precision="f32",
                    half=False) -> dict:
    """The reference's first three steps from ``weights`` over ``batches``
    (each (x, target, mask)); ``half`` leaves out the second half of each
    batch (a fault's reading)."""
    from reference.layers import no_tf32
    from reference.train import make

    no_tf32()
    buffers = (".running_mean", ".running_var", ".num_batches_tracked")
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in weights.items() if not k.endswith(buffers)}
    P = dict(weights, **params)
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = make(params, cfg["optimizer"])
    losses, grad1, logits1 = [], None, None
    for x, target, mask in batches:
        if half:
            n = x.shape[0] // 2
            x, target = x[:n], target[:n]
            mask = None if mask is None else mask[:n]
        logits = ref_mod.forward(P, x, cfg, train=True, precision=precision)
        if logits1 is None:
            logits1 = logits.detach().float().cpu()
        loss = loss_fn(logits, target, mask)
        grads = torch.autograd.grad(loss, list(params.values()))
        taken = opt.step(dict(zip(params, grads)))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: v.clone() for k, v in taken.items()}
    return {"losses": losses, "grad1": grad1, "p0": p0, "logits1": logits1,
            "p3": {k: v.detach().clone() for k, v in params.items()}}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a number above its limit
    (or missing) fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = {"value": v, "limit": limit, "ok": v is not None and v <= limit}
    return out


def report(checks: dict) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
