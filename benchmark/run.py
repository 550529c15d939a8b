"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix; the
harness finds their files, the cell's limits and the per-layer readers by
name (``core.py``). Set-up (imports, inputs and weights from the seed, the
program's model, kernels and server, the checked first steps, warm-up)
ends where the window starts; the window runs ``--seconds``. With ``--trace
1`` the per-layer metrics are read from spans, counters and the device
trace, and the end-to-end ones are not reported.

After the window the program's outputs are compared with the plain
reference; ``correct`` is whether every number is within its limit. The
last line on standard output is the result, JSON; the numbers compared are
its last key, and the last lines on standard error. Without a CUDA device
(or with fewer than the cell asks for), or with JAX loaded by the close,
the run prints no result and exits 2 or 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chexpert_tpu")
CACHE = ROOT / ".bench_cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Modules whose top-level name is JAX's, or the JAX package's, whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def set_env(cell) -> None:
    """The configuration's environment, and the build caches at fixed paths
    inside the checkout."""
    for key, value in cell.config.get("env", {}).items():
        os.environ[key] = str(value)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
    os.environ["USE_FLAX"] = "0"


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.strip()
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


class Ctx:
    """What a loop is given: the run's seed, window, tracing and device,
    and the record it fills for the per-layer readers."""

    def __init__(self, seed, seconds, trace, device, record):
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace)
        self.device, self.record = device, record


def numbers(cell, out, precision="f32", half=False) -> dict:
    """The numbers compared: the program's outputs (or, for a control or a
    fault's reading, the reference in lower precision or with half of each
    batch in the program's place) against the reference."""
    loop = cell.loop()
    if "reference_f32" not in out:
        out["reference_f32"] = out["reference"]("f32")
    want = out["reference_f32"]
    if precision == "f32" and not half:
        got = out["program"]
    else:
        got = out["reference"](precision, half)
    return {**loop.numbers(got, want), **out.get("exact", {})}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(result without "checks", checks, out) of one run of ``cell``."""
    from core import Record
    from check import judge

    import torch

    record = Record(trace)
    ctx = Ctx(seed, seconds, trace, device, record)
    out = cell.loop().run(cell, ctx)
    metrics = {}
    if not trace:
        reports = cell.traffic.get("reports", {})
        for m in cell.end_to_end:
            key = reports.get(m["name"], m["name"])
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": out["window_start"] - t_start, "unit": m["unit"]}
            elif key in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][key], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = judge(numbers(cell, out), cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload.get("chips", 1)),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        dev["busy_s"] = record.trace["busy_s"]
        dev["window_s"] = record.trace["window_s"]
        result["breakdown"] = record.trace["breakdown"]
    if "generator_late_ms" in out:
        result["generator_late_ms"] = out["generator_late_ms"]
    return result, checks, out


def main(argv=None) -> int:
    args = parse(argv)
    from core import find_cell

    cell = find_cell(args.workload)
    set_env(cell)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from check import report

    result, checks, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    report(checks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
