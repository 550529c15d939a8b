"""The losses and the optimizer step of the reference, written out."""

from __future__ import annotations

import torch


def bce_sum_mean(logits, targets, mask):
    """Binary cross-entropy with logits summed over the classes and averaged
    over the rows whose mask is 1 (the CheXpert reference's
    BCEWithLogitsLoss(reduction='none').sum(1).mean(0))."""
    x, y = logits, targets
    per = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return (per.sum(1) * mask).sum() / mask.sum()


def cross_entropy(logits, labels):
    """Mean over the rows of -log softmax(logits)[label]."""
    z = logits - logits.max(dim=1, keepdim=True).values.detach()
    logp = z - torch.log(torch.exp(z).sum(dim=1, keepdim=True))
    return -logp.gather(1, labels[:, None]).mean()


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of optimizer step ``step`` (0-based): linear warmup
    from 0 over ``warmup_steps`` (or the base rate held, ``warmup`` "hold"),
    then multistep decay by 10 at each milestone or a cosine over
    ``cosine_steps``."""
    import math

    base, warm = opt["lr"], opt.get("warmup_steps", 0)
    if step < warm:
        return base * step / warm if opt.get("warmup", "hold") == "linear" else base
    t = step - warm
    if opt["schedule"] == "multistep":
        return base * 0.1 ** sum(t >= m for m in opt["milestones"])
    if opt["schedule"] == "cosine":
        return 0.5 * base * (1 + math.cos(math.pi * min(t / opt["cosine_steps"], 1.0)))
    raise ValueError(f"schedule {opt['schedule']!r}")


class NesterovSGD:
    """SGD with Nesterov momentum and weight decay added to the gradient:
    d = g + wd p; buf = d on the first step, else mu buf + d; p -= lr (d +
    mu buf)."""

    def __init__(self, params: dict, opt: dict):
        if opt["kind"] != "sgd_nesterov":
            raise ValueError(f"optimizer {opt['kind']!r}")
        self.params, self.opt, self.step_count = params, opt, 0
        self.buf = {}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Update in place; returns d of each leaf (the gradient as the
        optimizer takes it)."""
        mu, wd = self.opt["momentum"], self.opt["weight_decay"]
        lr = lr_at(self.opt, self.step_count)
        taken = {}
        for name, p in self.params.items():
            d = grads[name] + wd * p
            taken[name] = d
            b = self.buf.get(name)
            b = d.clone() if b is None else b.mul_(mu).add_(d)
            self.buf[name] = b
            p.sub_(lr * (d + mu * b))
        self.step_count += 1
        return taken
