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
    then, on the clock ``step - warmup_steps``, the base rate held
    (``constant``), multistep decay by 10 at each milestone, a staircase
    exponential decay by ``decay_factor`` every ``decay_steps`` steps, or a
    cosine over ``cosine_steps``."""
    import math

    base, warm = opt["lr"], opt.get("warmup_steps", 0)
    if step < warm:
        return base * step / warm if opt.get("warmup", "hold") == "linear" else base
    t = step - warm
    if opt["schedule"] == "constant":
        return base
    if opt["schedule"] == "multistep":
        return base * 0.1 ** sum(t >= m for m in opt["milestones"])
    if opt["schedule"] == "exponential":
        return base * opt["decay_factor"] ** math.floor(t / opt["decay_steps"])
    if opt["schedule"] == "cosine":
        return 0.5 * base * (1 + math.cos(math.pi * min(t / opt["cosine_steps"], 1.0)))
    raise ValueError(f"schedule {opt['schedule']!r}")


class NesterovSGD:
    """SGD with Nesterov momentum and weight decay added to the gradient:
    d = g + wd p; buf = d on the first step, else mu buf + d; p -= lr (d +
    mu buf)."""

    def __init__(self, params: dict, opt: dict):
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


class Adam:
    """Adam (arXiv:1412.6980) as torch.optim.Adam computes it, with L2 weight
    decay added to the gradient: d = g + wd p; m = b1 m + (1 - b1) d; v = b2
    v + (1 - b2) d^2 (both from 0); at step t (1-based) p -= lr / (1 -
    b1^t) m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, params: dict, opt: dict):
        self.params, self.opt, self.step_count = params, opt, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        b1, b2 = self.opt["betas"]
        eps, wd = self.opt["eps"], self.opt["weight_decay"]
        lr = lr_at(self.opt, self.step_count)
        t = self.step_count + 1
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        taken = {}
        for name, p in self.params.items():
            d = grads[name] + wd * p
            taken[name] = d
            m, v = self.m[name], self.v[name]
            m.mul_(b1).add_((1 - b1) * d)
            v.mul_(b2).add_((1 - b2) * d * d)
            p.sub_(lr / c1 * m / (v.sqrt() / c2 ** 0.5 + eps))
        self.step_count += 1
        return taken


class RMSprop:
    """RMSprop in optax's order (the program's RMSpropLRInTrace): d = g + wd
    p; nu = decay nu + (1 - decay) d^2; u = d / (sqrt(nu) + eps); buf =
    momentum buf + lr_t u; p -= buf; nu and buf start at 0."""

    def __init__(self, params: dict, opt: dict):
        self.params, self.opt, self.step_count = params, opt, 0
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.buf = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        rho, eps = self.opt["decay"], self.opt["eps"]
        mu, wd = self.opt["momentum"], self.opt["weight_decay"]
        lr = lr_at(self.opt, self.step_count)
        taken = {}
        for name, p in self.params.items():
            d = grads[name] + wd * p
            taken[name] = d
            nu, buf = self.nu[name], self.buf[name]
            nu.mul_(rho).add_((1 - rho) * d * d)
            buf.mul_(mu).add_(lr * (d / (nu.sqrt() + eps)))
            p.sub_(buf)
        self.step_count += 1
        return taken


OPTIMIZERS = {"sgd_nesterov": NesterovSGD, "adam": Adam, "rmsprop": RMSprop}


def make(params: dict, opt: dict):
    """The optimizer the configuration's ``optimizer`` names by ``kind``."""
    if opt["kind"] not in OPTIMIZERS:
        raise ValueError(f"optimizer {opt['kind']!r} is not one of {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[opt["kind"]](params, opt)
