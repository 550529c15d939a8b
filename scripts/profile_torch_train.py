#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch port, on one card.

    python3 scripts/profile_torch_train.py [--batch 16] [--steps 10]

Builds aadensenet121 at 320x320 with seeded random weights and its
optimizer (SGD-Nesterov), puts one whitened batch on the card, and times
``chexpert_tpu_torch.train.train_step`` under bf16 autocast: steady-state
ms/step and images/s over ``--steps`` steps after 3 warm-up steps (host
clock around work that ends in a synchronize), and peak device memory.
Then profiles 3 steps with torch.profiler and prints the device time by
kernel name, the device busy share of the steps' wall time, and the time
and launches of B1 (rel_attention_fwd) and B2 (rel_attention_bwd_*), then
the profiler's own table. The input pipeline is not in the timed steps.
Needs a CUDA device.
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.models import build_model, optimizer_spec
    from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step

    kernels.build()
    model = build_model("aadensenet121", image_size=320,
                        generator=torch.Generator().manual_seed(0)).to("cuda")
    opt, sched, _ = make_optimizer(optimizer_spec("aadensenet121"), model.parameters(), 0.01)
    state = TrainState(model, opt, sched)
    rng = np.random.RandomState(0)
    batch = {
        "image": torch.from_numpy(rng.randn(args.batch, 320, 320, 1).astype(np.float32)),
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
    res = {"batch": args.batch, "ms_per_step": ms_step,
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
    dev = sorted(((getattr(e, attr) / 1e3 / n, e.count // n, e.key) for e in avgs
                  if getattr(e, attr) > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
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
                "rel_attention_fwd": kernel("rel_attention_fwd"),
                "rel_attention_bwd_dkdv": kernel("rel_attention_bwd_dkdv"),
                "rel_attention_bwd_dq": kernel("rel_attention_bwd_dq")})
    print("device time per step by kernel (ms, launches, name):")
    for t, c, k in dev[:25]:
        print(f"  {t:9.3f} {c:5d}  {k[:110]}")
    print(avgs.table(sort_by=attr, row_limit=30))
    smi = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader"
                   ).read().strip()
    print(json.dumps({**res, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
