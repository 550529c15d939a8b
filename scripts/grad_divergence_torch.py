#!/usr/bin/env python3
"""Where one f32 train step's gradients diverge between two runs of the
PyTorch port's aadensenet121 that differ only by rounding.

    python3 scripts/grad_divergence_torch.py [--image_size 320] [--batch 4]
        [--device cuda] [--out result.json]

Builds aadensenet121 with seeded random weights (seed 0) and takes the
first batch of the port's synthetic fixture, as chip_smoke.py's gradient
reference does. Runs one f32 forward and backward (train-mode BatchNorm,
TF32 off, deterministic cuDNN) three times: the reference on the einsum
attention route, the einsum route with the input scaled by 1 + 2^-23 (one
f32 ulp), and the kernel route. Hooks on every BatchNorm2d, InstanceNorm,
Conv2d, AAConv2d and the classifier record the module's output and its
gradients; each run is compared with the reference by
||a - b|| / ||b|| (and max |a - b| / max |b|) at every module, in the order
the backward reaches them. Per norm (each feeds a ReLU) it prints the relative
error of the output gradient, the amplification of the norm's own
backward (error of the input gradient over error of the output gradient),
the ReLU signs that differ from the reference and the jump of the error
across that ReLU, and for BatchNorm the share of the output gradient that
survives its projection (dy minus its per-channel mean and its x-hat
component; the relative error grows by about its inverse). Then a summary
by module type. Needs no card with
``--device cpu`` (use a small ``--image_size`` there).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import tempfile
from pathlib import Path

import torch
from torch import nn

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rel(a: torch.Tensor, b: torch.Tensor) -> tuple:
    a, b = a.double(), b.double()
    d = a - b
    return ((d.norm() / b.norm().clamp_min(1e-300)).item(),
            (d.abs().max() / b.abs().max().clamp_min(1e-300)).item())


def RELU_CONSUMER(norm: str) -> str:
    """The module that reads a norm's output through its ReLU."""
    head, _, leaf = norm.rpartition(".")
    if leaf in ("norm1", "norm2"):
        return f"{head}.conv{leaf[-1]}"
    if leaf == "norm" and ".transition" in f".{head}":
        return f"{head}.conv"
    return "classifier" if leaf == "norm5" else ""


def run(model, image, label, mask, device, scale=1.0):
    """One forward + backward; per hooked module its output, output grad,
    input grad and (BatchNorm) per-channel batch std."""
    from chexpert_tpu_torch.models import AAConv2d
    from chexpert_tpu_torch.models.common import InstanceNorm
    from chexpert_tpu_torch.train import prepare_image, train_loss

    types = (nn.BatchNorm2d, InstanceNorm, nn.Conv2d, AAConv2d, nn.Linear)
    inside_aa = {id(c) for m in model.modules() if isinstance(m, AAConv2d)
                 for c in m.modules() if c is not m}
    rec, order, hooks = {}, [], []
    for name, m in model.named_modules():
        if not isinstance(m, types) or id(m) in inside_aa:
            continue

        def fwd(m, inp, out, name=name):
            r = rec.setdefault(name, {"type": type(m).__name__})
            r["out"] = out.detach().clone()
            if isinstance(m, nn.BatchNorm2d):
                var = inp[0].detach().double().var(dim=(0, 2, 3), unbiased=False)
                r["scale"] = (m.weight.detach().double() / (var + m.eps).sqrt())

        def bwd(m, gin, gout, name=name):
            r = rec[name]
            r["gout"] = gout[0].detach().clone()
            r["gin"] = None if gin[0] is None else gin[0].detach().clone()
            order.append(name)

        hooks += [m.register_forward_hook(fwd), m.register_full_backward_hook(bwd)]
    model.train()
    x = (prepare_image(image) * scale).requires_grad_()  # the stem's hook sees an input grad
    loss = train_loss(model(x), label, mask)
    loss.backward()
    if device.type == "cuda":
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return loss.item(), rec, order


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_size", type=int, default=320)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="", help="write every module's numbers here as JSON")
    args = p.parse_args()
    from chexpert_tpu_torch.data import Batches, ChexpertIndex, make_synthetic_dataset
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as d:
        make_synthetic_dataset(d, n_train=16, n_valid=16, image_size=args.image_size)
        host = next(iter(Batches(ChexpertIndex(d, "train"), args.batch,
                                 image_size=args.image_size)))
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    sd = build_model("aadensenet121", image_size=args.image_size,
                     generator=torch.Generator().manual_seed(0)).state_dict()

    def go(route, scale=1.0):
        model = build_model("aadensenet121", image_size=args.image_size, attn_impl=route)
        model.load_state_dict(sd, strict=True)
        return run(model.to(device), batch["image"], batch["label"], batch["mask"], device,
                   scale)

    loss_ref, ref, order = go("einsum")
    runs = {"einsum_ulp": go("einsum", 1.0 + 2.0 ** -23), "kernel": go("pallas")}

    table = []
    for name in order:  # backward order: head first
        r = ref[name]
        row = {"module": name, "type": r["type"]}
        for tag, (_, rec, _) in runs.items():
            o = rec[name]
            row[f"{tag}.out"] = rel(o["out"], r["out"])
            row[f"{tag}.gout"] = rel(o["gout"], r["gout"])
            if r["gin"] is not None:
                row[f"{tag}.gin"] = rel(o["gin"], r["gin"])
                g = row[f"{tag}.gout"][0]
                row[f"{tag}.amp"] = row[f"{tag}.gin"][0] / g if g > 0 else float("nan")
            if r["type"] in ("BatchNorm2d", "InstanceNorm"):  # every norm feeds a ReLU
                row[f"{tag}.flips"] = int(((o["out"] > 0) != (r["out"] > 0)).sum())
                consumer = RELU_CONSUMER(name)
                if consumer in ref and ref[consumer]["gin"] is not None:
                    c = rel(rec[consumer]["gin"], ref[consumer]["gin"])[0]
                    row[f"{tag}.relu_jump"] = row[f"{tag}.gout"][0] / c if c > 0 else float("nan")
        if "scale" in r and r["gin"] is not None:  # share of dy left after BN's projection
            proj = r["gin"].double() / r["scale"].view(1, -1, 1, 1)
            row["bn_survive"] = (proj.norm() / r["gout"].double().norm()).item()
        table.append(row)

    print(f"aadensenet121 {args.image_size}x{args.image_size} f32 batch {args.batch} on "
          f"{device}: reference loss {loss_ref:.8f}; "
          + "; ".join(f"{t} loss {l:.8f}" for t, (l, _, _) in runs.items()))
    print("backward order; rel err = ||d|| / ||ref|| (max-based in brackets)")
    print("norms only (each feeds a ReLU): gout = rel err of the norm's output grad; amp = "
          "its backward's own growth; flips = ReLU signs that differ from the reference; "
          "jump = gout / rel err of the input grad of the ReLU's consumer")
    print(f"{'module':42s} {'ulp gout':>19s} {'amp':>5s} {'flips':>5s} {'jump':>8s} "
          f"{'kernel gout':>19s} {'amp':>5s} {'flips':>5s} {'jump':>8s} {'bn surv':>7s}")
    nan = float("nan")
    for row in table:
        if row["type"] not in ("BatchNorm2d", "InstanceNorm"):
            continue
        cols = []
        for tag in runs:
            g = row[f"{tag}.gout"]
            cols.append(f"{g[0]:9.2e} [{g[1]:7.1e}] {row.get(f'{tag}.amp', nan):5.2f} "
                        f"{row[f'{tag}.flips']:5d} {row.get(f'{tag}.relu_jump', nan):8.1f}")
        print(f"{row['module'].replace('features.', '')[:42]:42s} {' '.join(cols)} "
              f"{row.get('bn_survive', nan):7.3f}")

    summary = {}
    for tag in runs:
        fwd = max(row[f"{tag}.out"][0] for row in table)
        by_type = {}
        for t in ("BatchNorm2d", "Conv2d", "InstanceNorm", "AAConv2d", "Linear"):
            amps = [row[f"{tag}.amp"] for row in table
                    if row["type"] == t and math.isfinite(row.get(f"{tag}.amp", math.nan))]
            if amps:
                logs = [math.log10(a) for a in amps if a > 0]
                by_type[t] = {"n": len(amps), "median_amp": statistics.median(amps),
                              "max_amp": max(amps), "sum_log10_amp": sum(logs)}
        jumps = {True: [], False: []}
        for row in table:
            j = row.get(f"{tag}.relu_jump", math.nan)
            if math.isfinite(j):
                jumps[row[f"{tag}.flips"] > 0].append(j)
        relu = {"flips": sum(row.get(f"{tag}.flips", 0) for row in table),
                "relus_with_flips": len(jumps[True])}
        for flipped, js in jumps.items():
            if js:
                relu["with_flips" if flipped else "without_flips"] = {
                    "n": len(js), "median_jump": statistics.median(js), "max_jump": max(js)}
        by_type["ReLU"] = relu
        first = table[0][f"{tag}.gout"][0]
        last = next(row[f"{tag}.gin"][0] for row in reversed(table) if f"{tag}.gin" in row)
        summary[tag] = {"max_forward_rel": fwd, "head_gout_rel": first,
                        "input_gin_rel": last, "by_type": by_type}
    surv = [row["bn_survive"] for row in table if "bn_survive" in row]
    summary["bn_survive"] = {"n": len(surv), "median": statistics.median(surv),
                             "min": min(surv), "max": max(surv)}
    print("summary by module type (amp = rel err of input grad / rel err of output grad):")
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "table": table}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
