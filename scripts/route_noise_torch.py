#!/usr/bin/env python3
"""How far two f32 attention routes of aaresnet152 part on the same weights,
and what damping the residual branches does to it.

    python3 scripts/route_noise_torch.py [--device cuda] [--image_size 320]

For each residual scale (1, the seeded init, and 0.25, what chip_smoke.py
serves; see its damp_residuals): builds aaresnet152 from seed 0, sets the
scale, calibrates the BatchNorm statistics on four request images
(chip_smoke.calibrate_bn), and runs the same batch in f32, TF32 off, through
the einsum route, the bn kernel route and the hil kernel route (on a CPU
the wrappers run the kernels' plain versions). Prints, per kernel route,
max |logit - einsum logit| / max |einsum logit| and max |dp|, and how far
the logits move when every attention branch is zeroed (out_proj = 0), which
says whether the comparison can see the attention at all. One JSON line at
the end. A random-init ResNet-152 amplifies rounding through its 50 blocks;
this measures by how much, which no kernel can change.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--image_size", type=int, default=320)
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("route_noise_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from PIL import Image

    from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD
    from chexpert_tpu_torch.data.transforms import center_crop
    from chexpert_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.DEVICE = args.device
    size, name = args.image_size, cs.AA_RES
    images = cs.jpegs(cs.AA_REQUESTS, size)
    batch = [(center_crop(np.asarray(Image.open(io.BytesIO(d)).convert("L"), np.float32)[..., None],
                          size) / 255.0 - PIXEL_MEAN) / PIXEL_STD for d in images]
    x = torch.from_numpy(np.stack(batch).astype(np.float32)).expand(-1, -1, -1, 3)
    x = x.permute(0, 3, 1, 2).contiguous().to(args.device)

    def logits(sd, impl, layout):
        m = build_model(name, image_size=size, attn_impl=impl, attn_layout=layout)
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            return m.to(args.device).eval()(x).double().cpu()

    res = {}
    for gamma in (1.0, cs.AA_RESIDUAL_GAMMA):
        base = build_model(name, image_size=size, generator=torch.Generator().manual_seed(0))
        cs.damp_residuals(base, gamma)
        cs.calibrate_bn(base.to(args.device), images, size)
        sd = {k: v.cpu() for k, v in base.state_dict().items()}
        ref = logits(sd, "einsum", "bn")
        row = {}
        for layout in ("bn", "hil"):
            got = logits(sd, "pallas", layout)
            row[layout] = {"logit_rel": ((got - ref).abs().max() / ref.abs().max()).item(),
                           "max_abs_dp": (torch.sigmoid(got) - torch.sigmoid(ref)).abs().max().item()}
        zeroed = {k: torch.zeros_like(v) if k.endswith("out_proj.weight") else v
                  for k, v in sd.items()}
        row["attention_zeroed_logit_rel"] = (
            (logits(zeroed, "einsum", "bn") - ref).abs().max() / ref.abs().max()).item()
        res[f"residual_scale_{gamma}"] = row
        print(f"residual scale {gamma}: f32 kernel routes vs f32 einsum, logits max |d| / max "
              f"|logit| bn {row['bn']['logit_rel']:.3g} hil {row['hil']['logit_rel']:.3g}; |dp| "
              f"bn {row['bn']['max_abs_dp']:.3g} hil {row['hil']['max_abs_dp']:.3g}; attention "
              f"zeroed moves the logits by {row['attention_zeroed_logit_rel']:.3g} of the largest",
              flush=True)
    card = "cpu"
    if args.device == "cuda":
        card = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader"
                        ).read().strip()
    print(json.dumps({"model": name, "image_size": size, "device": args.device, **res,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
