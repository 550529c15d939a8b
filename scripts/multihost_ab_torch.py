#!/usr/bin/env python3
"""What ``--multihost`` costs one process: chip_smoke.py phase 5's train run
(aadensenet121 320x320, bf16, batch 16, 6 steps, lr 0.01, through
cli.chexpert.main) without and with ``--multihost`` as a world of 1 under
NCCL (torchrun's variables set in this process), alternating plain, NCCL,
NCCL, plain, plain, NCCL, in one process on one card.

    python3 scripts/multihost_ab_torch.py

Prints one line per run (its mode, ms/step from the median images/s of
steps 2..6, and every step's ms), then the card. Each run is gated as phase
5 gates it (launches, falling loss, artifacts).
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.data import make_synthetic_dataset
    from chexpert_tpu_torch.ops import kernel_targets
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME

    smi = cs.smi_line()
    kernels.build(kernel_targets())
    per_step = {NAME: 3, BWD_DKDV: 3, BWD_DQ: 3}
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=cs.B_TRAIN, n_valid=cs.B_TRAIN, image_size=cs.IMAGE)
        for i, mode in enumerate(("plain", "nccl", "nccl", "plain", "plain", "nccl")):
            run = {"data_dir": d, "smi": smi, "model": "aadensenet121", "image": cs.IMAGE,
                   "lr": cs.TRAIN_LR, "per_step": per_step, "per_eval": {NAME: 3},
                   "run": f"run{i}"}
            if mode == "nccl":
                with cs.launch_env(0, 1, cs.free_port()):
                    r = cs.train_phase(**run, extra=("--multihost",))
            else:
                r = cs.train_phase(**run)
            print(f"AB {mode}: {r['ms_per_step']:.2f} ms/step (steps: "
                  f"{[round(cs.B_TRAIN / x * 1e3, 1) for x in r['images_per_sec']]})", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
