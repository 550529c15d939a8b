#!/usr/bin/env python3
"""ms/step, device ms and attention-kernel ms of WideResNet-28-10 with the
heads past the largest width class, through the CIFAR bench.

    python3 scripts/bench_wrn_step_torch.py [--layouts bn,hil]

Needs one CUDA card. Runs ``chip_smoke.py``'s ``bench_run`` on
``BENCH_WRN_WIDE`` (``cli.bench wideresnet 28 10 --attn --attn_k 0.5
--attn_v 0.2 --attn_nh 1 --synthetic --mini_data``, 8 steps, batch 256, bf16,
one eval) under each layout, with its gates (launches per step and eval
forward, finite losses) and its profiled steps, and prints one line per
layout and, last, one JSON object with every number and the card's name and
power limit. It imports ``chip_smoke`` from the directory it is run in, so
it also runs from a checkout of an earlier commit of the port (with this
file copied into its ``scripts/``): two commits are timed in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="bn,hil", help="attention layouts, comma-separated")
    a = ap.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME
    from chexpert_tpu_torch.ops.hil_attention import BWD_PASSES, FWD

    smi, out, n = cs.smi_line(), {}, 8  # 8 AA convs a step
    for layout in a.layouts.split(","):
        per_step = ({NAME: n, BWD_DKDV: n, BWD_DQ: n} if layout == "bn"
                    else {FWD: n, **{p: n for p in BWD_PASSES}})
        per_eval = {NAME: n} if layout == "bn" else {FWD: n}
        r = cs.bench_run(cs.BENCH_WRN_WIDE, layout, smi, per_step, per_eval,
                         cs.BENCH_WRN_STEPS,
                         extra=("--mini_data", "--n_epochs", str(cs.BENCH_WRN_STEPS),
                                "--lr_warmup_epochs", "0", "--evaluate"))
        out[layout] = {k: r[k] for k in ("ms_per_step", "device_ms_per_step",
                                         "device_ms_by_group", "losses", "busy_share",
                                         "step_ms")}
    print(json.dumps({"card": smi, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
