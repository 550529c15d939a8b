"""CheXpert training, closed loop: the program's train step
(``train/steps.py::train_step``) over ``device_prefetch(Batches(...))``, as
``train/loop.py::train_epoch`` drives it, on a seeded CheXpert-small tree
written under TMPDIR in set-up. The loss is read every ``log_interval``
steps (the CLI's default); no eval inside the window.

Traffic keys: rows (csv rows), pool (distinct JPEGs the rows use in turn),
batch, workers (decode threads), prefetch (batches in flight),
warmup_steps, log_interval, trace_steps. Result: img_per_s."""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

import attn_ranges
import inputs
from check import reference_train, train_numbers
from loops.train_common import checked_steps, finish, release, window
from reference.data import chexpert_targets, radiograph_input, shuffled_rows, to_tensor
from reference.train import bce_sum_mean
import weights as weights_mod


def _feed(index, tr, cfg, seed, device):
    """Batches on the device, epoch after epoch."""
    from chexpert_tpu_torch.data import Batches
    from chexpert_tpu_torch.data.pipeline import device_prefetch

    epoch = 0
    while True:
        yield from device_prefetch(
            Batches(index, tr["batch"], shuffle=True, augment=False,
                    image_size=cfg["image_size"], workers=tr["workers"], drop_last=True,
                    seed=seed, epoch=epoch), device, depth=tr["prefetch"])
        epoch += 1


def _program(cell, ctx, root, W_dev, seed):
    from chexpert_tpu_torch.data import ChexpertIndex
    from chexpert_tpu_torch.models import build_model, optimizer_spec
    from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step

    cfg, tr, device = cell.config, cell.traffic, ctx.device
    prog = cfg["program"]
    model = build_model(prog["model"], image_size=cfg["image_size"],
                        attn_layout=prog["attn_layout"], device=device)
    model.load_state_dict(W_dev, strict=True)
    opt, sched, _ = make_optimizer(optimizer_spec(prog["model"]), model.parameters(),
                                   cfg["optimizer"]["lr"])
    state = TrainState(model, opt, sched, generator=torch.Generator(device=device).manual_seed(seed))
    dtype = getattr(torch, cfg["compute_dtype"])
    index = ChexpertIndex(root, "train", download=False)
    feed = _feed(index, tr, cfg, seed, device)

    def first_step():
        batch = next(feed)
        return train_step(state, batch, dtype), batch["index"].cpu().numpy()

    undo = attn_ranges.install() if ctx.trace else None
    checked = checked_steps(model, opt, first_step)
    for _ in range(tr["warmup_steps"]):
        train_step(state, next(feed), dtype)
    run = window(ctx, lambda: next(feed), lambda b: train_step(state, b, dtype), tr["batch"],
                 tr["log_interval"], tr["trace_steps"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if undo is not None:
        undo()
    feed.close()
    return checked, run, peak


def run(cell, ctx) -> dict:
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    seed = ctx.seed % (2 ** 31)
    root = tempfile.mkdtemp(prefix="chexpert-", dir=os.environ.get("TMPDIR"))
    try:
        paths, labels = inputs.chexpert_tree(root, ctx.seed, tr["rows"], tr["pool"],
                                             cfg["image_size"])
        W_dev = weights_mod.make(ref.shapes(cfg), ctx.seed, ctx.device)
        W = {k: v.cpu() for k, v in W_dev.items()}
        checked, run_, peak = _program(cell, ctx, root, W_dev, seed)
        del W_dev
        out = finish(ctx, cell, ref, run_, tr["batch"], peak)
        release()
        # the reference: its own row order, decode and targets
        order = shuffled_rows(tr["rows"], seed)
        bs = tr["batch"]
        want = [order[i * bs:(i + 1) * bs] for i in range(3)]
        mismatched = sum(int((np.asarray(r) != w).sum()) for r, w in zip(checked["rows"], want))
        norm = cfg["normalization"]
        cache = {}
        batches = []
        for rows in want:
            xs = []
            for r in rows:
                if paths[r] not in cache:
                    with open(os.path.join(root, paths[r]), "rb") as f:
                        cache[paths[r]] = radiograph_input(f.read(), cfg["image_size"],
                                                           norm["mean"], norm["std"])
                xs.append(cache[paths[r]])
            batches.append((to_tensor(np.stack(xs), ctx.device),
                            to_tensor(chexpert_targets(labels[rows], inputs.LABELS_14),
                                      ctx.device),
                            torch.ones(len(rows), device=ctx.device)))
        W_ref = {k: v.to(ctx.device) for k, v in W.items()}
        out["reference"] = lambda precision="f32", half=False: reference_train(
            ref, cfg, W_ref, batches, bce_sum_mean, precision, half)
        out["program"] = checked
        out["exact"] = {"rows_mismatched": mismatched}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def numbers(got: dict, want: dict) -> dict:
    return train_numbers(got, want)
