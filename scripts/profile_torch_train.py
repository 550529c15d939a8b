#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch port, on one card.

    python3 scripts/profile_torch_train.py [--model aadensenet121] [--batch 16]
        [--steps 10] [--attn_layout bn|hil]

Builds ``--model`` (aadensenet121 at 320x320 by default; aaresnet152 and
resnet152 at 320x320; efficientnet-b* at its own resolution in
SCALING_PARAMS) with seeded random weights and its optimizer (SGD-Nesterov
at lr 0.01 for aadensenet121, Adam at lr 1e-4 for the ResNets, RMSprop +
per-step exponential decay at lr 3e-4 for EfficientNet: the learning
rates chip_smoke.py trains them at), in the attention layout
``--attn_layout`` (default: the CHEXPERT_ATTN_LAYOUT variable, else bn),
puts one whitened batch on
the card, and times ``chexpert_tpu_torch.train.train_step`` under bf16
autocast: steady-state ms/step and images/s over ``--steps`` steps after 3
warm-up steps (host clock around work that ends in a synchronize), and
peak device memory. Then profiles 3 steps with torch.profiler and prints
the device time by kernel name, the device busy share of the steps' wall
time, and the time and launches of each of the port's kernels (B1
rel_attention_fwd, B2 rel_attention_bwd_*, B3 depthwise_fwd, B4
depthwise_bwd, B5 hil_attention_fwd, B6 hil_attention_bwd_*), then the
profiler's own table. For a model with AA convs it then profiles the forward
and backward of one stride-1 AA conv alone (the last one of the model, on a
seeded input of its shape) and lists every device kernel of that layer with
its launches, so that the data-sized copies around the attention kernels
can be counted. The input pipeline is not in the timed steps. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def profile_aa_layer(layer, batch: int, attr: str) -> dict:
    """Forward and backward of one AA conv alone under bf16 autocast: every
    device kernel with its launches and time, forward and backward apart."""
    from torch.profiler import ProfilerActivity, profile

    H, W = layer.input_dims
    cin, s = layer.in_proj_qkv.in_channels, layer.strides
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(batch, cin, H * s, W * s, device="cuda", generator=gen).requires_grad_()
    out = {"input": list(x.shape), "stride": s, "attn_layout": layer.attn_layout}
    for _ in range(2):  # warm up
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = layer(x)
        y.float().sum().backward()
    for phase in ("forward", "backward"):
        torch.cuda.synchronize()
        if phase == "forward":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    y = layer(x)
                torch.cuda.synchronize()
            loss = y.float().sum()
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                loss.backward()
                torch.cuda.synchronize()
        rows = sorted(((getattr(e, attr) / 1e3, e.count, e.key) for e in prof.key_averages()
                       if getattr(e, attr) > 0
                       and e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
        print(f"AA conv alone ({layer.attn_layout}, input {list(x.shape)}, stride {s}), "
              f"{phase}: device kernels (ms, launches, name):")
        for t, c, k in rows:
            print(f"  {t:9.4f} {c:4d}  {k[:120]}")
        out[phase] = {"kernels": sum(c for _, c, _ in rows), "ms": sum(t for t, _, _ in rows)}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="aadensenet121")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--attn_layout", default=None, choices=["bn", "hil"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.models import AAConv2d, build_model, optimizer_spec
    from chexpert_tpu_torch.models.efficientnet import SCALING_PARAMS
    from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step

    effnet = args.model in SCALING_PARAMS
    size = SCALING_PARAMS[args.model][2] if effnet else 320
    lr = 3e-4 if effnet else 1e-4 if "resnet" in args.model else 0.01
    kernels.build()
    model = build_model(args.model, image_size=size, attn_layout=args.attn_layout,
                        generator=torch.Generator().manual_seed(0)).to("cuda")
    aa = [m for m in model.modules() if isinstance(m, AAConv2d)]
    opt, sched, _ = make_optimizer(optimizer_spec(args.model), model.parameters(), lr)
    state = TrainState(model, opt, sched,
                       generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {
        "image": torch.from_numpy(rng.randn(args.batch, size, size, 1).astype(np.float32)),
        "label": torch.from_numpy((rng.rand(args.batch, 5) < 0.4).astype(np.float32)),
        "label_mask": torch.ones(args.batch, 5),
        "mask": torch.ones(args.batch),
    }
    batch = {k: v.to("cuda") for k, v in batch.items()}

    def step():
        return train_step(state, batch, torch.bfloat16)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / args.steps
    res = {"model": args.model, "image_size": size, "batch": args.batch, "lr": lr,
           "attn_layout": aa[0].attn_layout if aa else None,
           "ms_per_step": ms_step,
           "images_per_sec": args.batch / ms_step * 1e3, "loss": float(loss),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    from torch.profiler import ProfilerActivity, profile

    n = 3  # profiled steps; every number below is per step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    avgs = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    # device kernels and copies; a user annotation's range on the device
    # timeline (the optimizer's step) would count its kernels twice
    dev = sorted(((getattr(e, attr) / 1e3 / n, e.count // n, e.key) for e in avgs
                  if getattr(e, attr) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 reverse=True)
    if not dev:
        print("profile_torch_train: the profiler recorded no device time", file=sys.stderr)
        return 1
    busy_ms = sum(t for t, _, _ in dev)

    def kernel(name):
        hits = [(t, c) for t, c, k in dev if name in k]
        return {"ms": sum(t for t, _ in hits), "launches": sum(c for _, c in hits)}

    res.update({"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / wall_ms,
                "device_kernels": sum(c for _, c, _ in dev),
                **{name: kernel(name) for name in (
                    "rel_attention_fwd", "rel_attention_bwd_dkdv", "rel_attention_bwd_dq",
                    "depthwise_fwd", "depthwise_bwd", "hil_attention_fwd",
                    "hil_attention_bwd_dkdv", "hil_attention_bwd_dq",
                    "hil_attention_bwd_drel")}})
    print("device time per step by kernel (ms, launches, name):")
    for t, c, k in dev[:25]:
        print(f"  {t:9.3f} {c:5d}  {k[:110]}")
    print(avgs.table(sort_by=attr, row_limit=30))
    if aa:
        res["aa_layer"] = profile_aa_layer(aa[-1], args.batch, attr)
    smi = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader"
                   ).read().strip()
    print(json.dumps({**res, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
