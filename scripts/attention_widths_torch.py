#!/usr/bin/env python3
"""Register and shared-memory report of the attention libraries, one per
source and head-width class.

    python3 scripts/attention_widths_torch.py [--out F]

Needs nvcc (the CUDA toolkit) and one CUDA card. Builds every attention
library (``ops/fused_attention.py::width_targets``: each source of
``WIDTH_SOURCES`` in each class of ``WIDTH_CLASSES``) by ``kernels.build``,
all together, where it is not current yet, and prints from each build's
``-Xptxas -v`` report (``kernels.ptxas_report``, kept beside the library)
per kernel instantiation its registers, shared memory, stack frame and
spill bytes, flagging any that spills or passes 255 registers. The last
line is one JSON object with every number and the card's name and power
limit (nvidia-smi); ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()

    import torch

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.ops.fused_attention import width_targets

    if not torch.cuda.is_available():
        print("attention_widths_torch: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    record = {"card": smi, "libraries": {}}
    flagged = []
    targets = width_targets()
    took = kernels.build(targets)
    record["build_s"] = took
    for target in targets:
        name = kernels.label(target)
        ks = kernels.ptxas_report(target)
        for k in ks:
            if k.get("spill_stores", 0) or k.get("registers", 0) > 255:
                flagged.append((name, k["kernel"], k.get("registers"), k.get("spill_stores")))
        record["libraries"][name] = {"kernels": ks}
        print(f"{name}: {len(ks)} kernels, registers "
              f"{sorted({k.get('registers', 0) for k in ks})}, spill stores "
              f"{sum(k.get('spill_stores', 0) for k in ks)} bytes", flush=True)
        for k in ks:
            print(f"    {k.get('registers', '?'):>3} reg  {k.get('static_smem', 0):>6} B smem  "
                  f"{k.get('stack', 0):>5} B stack  {k.get('spill_stores', 0):>5} / "
                  f"{k.get('spill_loads', 0):>5} B spill st / ld  {k['kernel'][:150]}")
    record["spilling_or_over_255"] = flagged
    print(f"{len(targets)} attention libraries built together in {max(took.values()):.1f} s "
          f"(0 where current) on {smi}; kernels that spill or pass 255 registers: "
          f"{len(flagged)}", flush=True)
    line = json.dumps(record)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
