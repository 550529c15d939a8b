"""The CIFAR test-bench's training, closed loop: per step the bench CLI's
own path (``cli/bench.py``): ``augment`` on the host, ``to_device``, then
``cli.bench.train_step``, the loss read every ``log_interval`` steps (the
CLI's default is every step), over epochs of a seeded permutation of
CIFAR-shaped data drawn from the seed.

Traffic keys: n_train, batch, warmup_steps, log_interval, trace_steps. Result:
img_per_s."""

from __future__ import annotations

import numpy as np
import torch

import attn_ranges
import inputs
from check import reference_train, train_numbers
from loops.train_common import checked_steps, finish, release, window
from reference.data import cifar_augmented, to_tensor
from reference.train import cross_entropy
import weights as weights_mod


def _program(cell, ctx, x, y, W_dev, seed):
    from chexpert_tpu_torch.cli import bench
    from chexpert_tpu_torch.train import make_optimizer

    cfg, tr, device = cell.config, cell.traffic, ctx.device
    args = bench.build_parser().parse_args(
        [*cfg["program"]["argv"], "--batch_size", str(tr["batch"]), "--seed", str(seed)])
    n_batches = len(x) // args.batch_size
    model, spec, kw = bench.build_bench_model(args, cfg["num_classes"], n_batches)
    model = model.to(device)
    model.load_state_dict(W_dev, strict=True)
    opt, sched, _ = make_optimizer(spec, model.parameters(), args.lr, **kw)
    generator = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg["compute_dtype"])
    rng = np.random.RandomState(inputs.seed32(seed))
    state = {"order": rng.permutation(len(x)), "pos": 0}

    def feed():
        if state["pos"] + args.batch_size > len(x):
            state["order"], state["pos"] = rng.permutation(len(x)), 0
        idx = state["order"][state["pos"]:state["pos"] + args.batch_size]
        state["pos"] += args.batch_size
        xb = bench.to_device(bench.augment(x[idx], rng), device)
        return xb, torch.from_numpy(y[idx]).to(device), idx

    def step(b):
        return bench.train_step(model, opt, sched, b[0], b[1], dtype, generator)

    def first_step():
        b = feed()
        return step(b), b[2]

    undo = attn_ranges.install() if ctx.trace else None
    checked = checked_steps(model, opt, first_step)
    for _ in range(tr["warmup_steps"]):
        step(feed())
    run = window(ctx, feed, step, args.batch_size, tr["log_interval"], tr["trace_steps"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if undo is not None:
        undo()
    return checked, run, peak


def run(cell, ctx) -> dict:
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    seed = ctx.seed % (2 ** 31)
    x, y = inputs.cifar(ctx.seed, tr["n_train"], cfg["num_classes"])
    W_dev = weights_mod.make(ref.shapes(cfg), ctx.seed, ctx.device)
    W = {k: v.cpu() for k, v in W_dev.items()}
    checked, run_, peak = _program(cell, ctx, x, y, W_dev, seed)
    del W_dev
    out = finish(ctx, cell, ref, run_, tr["batch"], peak)
    release()
    # the reference replays the loop's draws: the permutation, then each
    # batch's crop offsets and flips
    rng = np.random.RandomState(inputs.seed32(seed))
    order = rng.permutation(len(x))
    bs, norm = tr["batch"], cfg["normalization"]
    batches = []
    for i in range(3):
        idx = order[i * bs:(i + 1) * bs]
        xb = to_tensor(cifar_augmented(x[idx], rng, norm["mean"], norm["std"]), ctx.device)
        batches.append((xb, torch.from_numpy(y[idx]).to(ctx.device), None))
    W_ref = {k: v.to(ctx.device) for k, v in W.items()}
    mismatched = sum(int((np.asarray(r) != order[i * bs:(i + 1) * bs]).sum())
                     for i, r in enumerate(checked["rows"]))
    out["reference"] = lambda precision="f32", half=False: reference_train(
        ref, cfg, W_ref, batches, lambda logits, t, m: cross_entropy(logits, t), precision, half)
    out["program"] = checked
    out["exact"] = {"rows_mismatched": mismatched}
    return out


def numbers(got: dict, want: dict) -> dict:
    return train_numbers(got, want)
