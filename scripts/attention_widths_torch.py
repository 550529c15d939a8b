#!/usr/bin/env python3
"""Register and shared-memory report of the attention libraries, one per
source and head-width class.

    python3 scripts/attention_widths_torch.py [--out F]

Needs nvcc (the CUDA toolkit) and one CUDA card. Compiles every attention
library (``ops/fused_attention.py::width_targets``: each source of
``WIDTH_SOURCES`` in each class of ``WIDTH_CLASSES``) with the flags that
``kernels.build`` uses plus ``-Xptxas -v``, all together, into a temporary
directory (the libraries ``kernels.load`` serves are not touched), and
prints per kernel instantiation its registers, shared memory, stack frame
and spill bytes, flagging any that spills or passes 255 registers. The last
line is one JSON object with every number and the card's name and power
limit (nvidia-smi); ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_ENTRY = re.compile(r"Compiling entry function '(\w+)' for '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def demangle(names):
    """The C++ names of mangled symbols, where c++filt is installed."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.split("\n")
        return dict(zip(names, out))
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}


def parse(log: str) -> list:
    """One record per kernel of a ``-Xptxas -v`` log."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"symbol": m.group(1), "arch": m.group(2)}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return kernels


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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(kernels.label(t), subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *t[1], "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{i}.so"), str(kernels.CSRC_DIR / f"{t[0]}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, t in enumerate(width_targets())]
        logs = {name: proc.communicate()[0] for name, proc in procs}
    record["wall_s"] = time.perf_counter() - t0
    failed = [f"{name}:\n{logs[name]}" for name, proc in procs if proc.returncode != 0]
    if failed:
        print("attention_widths_torch: nvcc failed\n" + "\n".join(failed), file=sys.stderr)
        return 1
    for name, _ in procs:
        ks = parse(logs[name])
        names = demangle([k["symbol"] for k in ks])
        for k in ks:
            k["kernel"] = names[k["symbol"]]
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
    print(f"{len(procs)} attention libraries compiled together in {record['wall_s']:.1f} s "
          f"on {smi}; "
          f"kernels that spill or pass 255 registers: {len(flagged)}", flush=True)
    line = json.dumps(record)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
