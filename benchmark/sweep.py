"""Find the serving knee: run a serving cell at each of several fixed rates
in one process and report, per rate, the latency percentiles, the rate of
answers and whether the backlog grew (the median latency of the window's
last third over its first third).

    python3 benchmark/sweep.py --workload W --rates 10,20,30 --seconds 15 [--seed N]
"""

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
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import run
    from core import find_cell, median

    cell = find_cell(args.workload)
    run.set_env(cell)
    import torch

    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate"] = rate
        result, checks, out = run.run_cell(cell, args.seed, args.seconds, True, device,
                                           time.perf_counter())
        ans = sorted(out["program"]["answers"], key=lambda a: a["due"])
        ok = [a for a in ans if a.get("status") == 200]
        lat = [(a["done"] - a["due"]) * 1e3 for a in ok]
        third = max(1, len(lat) // 3)
        span = max(a["done"] for a in ok) - min(a["sent"] for a in ok) if ok else 0
        print(json.dumps({"rate": rate, "requests": len(ans), "answered": len(ok),
                          "answers_per_s": len(ok) / span if span else None,
                          "p50_ms": median(lat), "p90_ms": sorted(lat)[int(0.90 * (len(lat) - 1))]
                          if lat else None,
                          "growth": median(lat[-third:]) / median(lat[:third]) if lat else None,
                          "per_layer": {k: v["value"] for k, v in result["metrics"].items()},
                          "correct": all(c["ok"] for c in checks.values()),
                          "late_ms": out.get("generator_late_ms")}), flush=True)
        del out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
