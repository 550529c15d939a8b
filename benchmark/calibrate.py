"""Readings that set a cell's limits, several seeds in one process.

    python3 benchmark/calibrate.py --workload W --seeds 1,2,3 [--seconds S]
        [--controls K] [--out FILE]

For each seed: one run of the cell (as ``run.py`` makes it, window
``--seconds``) and the numbers its comparison reads (the lower readings).
For the first ``--controls`` seeds also the control, the reference in the
precision below the configuration's (fp8) in the program's place, and, for
training cells, the fault "half of each batch left out" planted in the
reference (the upper readings). One JSON line per seed on standard output
(and appended to ``--out``)."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import run
    from core import find_cell

    cell = find_cell(args.workload)
    run.set_env(cell)
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    t = T_START
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats() if device.type == "cuda" else None
        result, checks, out = run.run_cell(cell, seed, args.seconds, bool(args.trace), device, t)
        line = {"workload": cell.name, "seed": seed, "result": result,
                "program": run.numbers(cell, out)}
        if "losses" in out["program"]:
            line["losses"] = {"program": out["program"]["losses"],
                              "reference": out["reference_f32"]["losses"]}
        if i < args.controls:
            t1 = time.perf_counter()
            line["control_fp8"] = run.numbers(cell, out, "fp8")
            line["reference_bf16"] = run.numbers(cell, out, "bf16")
            if "train" in cell.traffic["loop"]:
                line["fault_half_batch"] = run.numbers(cell, out, "f32", half=True)
            line["control_s"] = time.perf_counter() - t1
        del out
        s = json.dumps(line)
        print(s, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(s + "\n")
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
