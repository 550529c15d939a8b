#!/usr/bin/env python3
"""Device time of the depthwise conv kernels, B3 (forward) and B4 (backward),
per geometry.

    python3 scripts/bench_depthwise_torch.py [--out FILE] [--sass]

Needs one CUDA card. At the ten stride-1 geometries of efficientnet-b4 at
380x380, in bf16 (the served and trained dtype), it runs B3 at batch 4
(serving) and 16 (training) and B4 at batch 16 (``ops/depthwise.py``) once
against their plain versions (largest error relative to the largest value),
then times each two ways:

* ``ms``: one input, its calls captured in a CUDA graph and replayed between
  CUDA events (``device_ms`` of chip_smoke.py: median of 10 replays of 10
  calls). The smaller maps stay in the card's 50 MB L2 from call to call.
* ``cold_ms``: the same, with the calls of the graph rotating over copies of
  the inputs that hold more than 100 MB together, so each call finds its
  inputs in HBM, as the bound counts them.

Beside them the bound (bytes over 3.35 TB/s against operations over the f32
peak outside the tensor cores, 67 TFLOP/s; the larger binds) and the library
call (``F.conv2d(groups=C)`` for B3, ``aten.convolution_backward`` for B4),
by the same graph replay. With ``--sass`` it first compiles the two sources
with ``nvcc -Xptxas -v`` and prints each kernel instantiation's registers,
spills and SASS instruction counts by opcode
(``cuobjdump -sass``). Prints one line per geometry and, last, one JSON
object with every number, the sums over the 28 layers (per served forward,
per train forward, per train step) and the card's name and power limit. It
calls only the wrappers' public functions, so it also runs from a checkout
of an earlier commit of the port: two commits can be timed in one run on one
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (H = W, C, k, layers) of efficientnet-b4's stride-1 depthwise layers at 380x380
GEOMETRIES = ((190, 48, 3, 1), (190, 24, 3, 1), (95, 192, 3, 3), (48, 336, 5, 3),
              (24, 672, 3, 5), (24, 672, 5, 1), (24, 960, 5, 5), (12, 1632, 5, 7),
              (12, 1632, 3, 1), (12, 2688, 3, 1))
SERVE_BATCH, TRAIN_BATCH = 4, 16
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12
COLD_BYTES = 100e6  # more than the 50 MB L2: rotating copies leave none of them there
REPS = 10


def graph_ms(calls, reps: int = REPS) -> float:
    """Median over reps of the device time per call: the calls captured in
    one CUDA graph and replayed between CUDA events."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> dict:
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations"}


def rel_err(got, want) -> float:
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


def bench(fn, inputs) -> dict:
    """fn(*inputs) hot (10 calls on one input) and cold (calls rotating over
    copies holding more than COLD_BYTES)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs if t.dim() == 4)
    n_copies = max(2, int(COLD_BYTES // nbytes) + 1)
    copies = [[t.clone() if t.dim() == 4 else t for t in inputs] for _ in range(n_copies)]
    hot = graph_ms([lambda: fn(*inputs)] * 10)
    cold = graph_ms([(lambda c=c: fn(*c)) for c in copies])
    del copies
    torch.cuda.empty_cache()
    return {"ms": hot, "cold_ms": cold, "cold_copies": n_copies}


def sass_report() -> dict:
    """Registers, spills and SASS opcode counts of each depthwise kernel
    instantiation, compiled as chexpert_tpu_torch.kernels compiles them."""
    import re
    import tempfile

    from chexpert_tpu_torch import kernels

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("depthwise_fwd", "depthwise_bwd"):
            lib = Path(tmp) / f"{name}.so"
            log = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                  str(lib), str(kernels.CSRC_DIR / f"{name}.cu")],
                                 capture_output=True, text=True, check=True).stderr
            for fn, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
                                       log, re.S):
                kind = re.search(r"(fwd|bwd)_kernelI(13__nv_bfloat16|f)Li(\d)E", fn)
                key = f"{kind.group(1)}_{'bf16' if kind.group(2) != 'f' else 'f32'}_k{kind.group(3)}"
                report[key] = {
                    "registers": int(re.search(r"Used (\d+) registers", body).group(1)),
                    "spill_bytes": int(re.search(r"(\d+) bytes spill stores", body).group(1)),
                    "mangled": fn}
            cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
            sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                                  text=True, check=True).stdout
            for fn, body in re.findall(r"Function : (\w+)\n(.*?)(?=Function :|\Z)", sass, re.S):
                key = next((k for k, v in report.items() if v["mangled"] == fn), None)
                if key is None:
                    continue
                ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
                counts = {op: ops.count(op) for op in sorted(set(ops))}
                report[key]["sass_total"] = len(ops)
                report[key]["sass"] = {op: n for op, n in counts.items()
                                       if op.split("_")[0] in ("FFMA", "LDS", "LDGSTS", "STG", "STS",
                                                               "SHF", "SEL", "LOP3", "BAR", "IMAD")}
    for key in sorted(report):
        r = report[key]
        print(f"{key}: {r['registers']} registers, {r['spill_bytes']} bytes spilled, "
              f"{r.get('sass_total')} SASS instructions {r.get('sass')}", flush=True)
        r.pop("mangled")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--sass", action="store_true",
                    help="first print registers, spills and SASS opcode counts per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_depthwise_torch: needs a CUDA device", file=sys.stderr)
        return 1
    sass = sass_report() if args.sass else None
    from chexpert_tpu_torch.ops.depthwise import (
        depthwise_bwd,
        depthwise_bwd_plain,
        depthwise_fwd,
        depthwise_fwd_plain,
    )

    dtype = torch.bfloat16
    es = torch.finfo(dtype).bits // 8
    gen = torch.Generator().manual_seed(7)
    rows = []
    for H, C, k, layers in GEOMETRIES:
        p = k // 2
        w = (torch.randn(C, 1, k, k, generator=gen) * 0.2).cuda()
        w_lib = w.to(dtype)
        row = {"geometry": f"{H}x{H}", "C": C, "k": k, "layers": layers}
        for batch in (SERVE_BATCH, TRAIN_BATCH):
            x = torch.randn(batch, C, H, H, generator=gen).to("cuda", dtype)
            n = x.numel()
            err = rel_err(depthwise_fwd(x, w), depthwise_fwd_plain(x, w))
            row[f"fwd{batch}"] = {
                "rel_err": err, **bench(depthwise_fwd, [x, w]),
                "library_ms": graph_ms([lambda: F.conv2d(x, w_lib, padding=p, groups=C)] * 10),
                **bound_ms(2 * n * es + w.numel() * 4, 2 * k * k * n)}
        g = torch.randn(x.shape, generator=gen).to("cuda", dtype)  # x: the training batch
        dx, dw = depthwise_bwd(x, w, g)
        dx_p, dw_p = depthwise_bwd_plain(x, w, g)

        def library(g_, x_):
            return torch.ops.aten.convolution_backward(
                g_, x_, w_lib, None, [1, 1], [p, p], [1, 1], False, [0, 0], C, [True, True, False])

        row["bwd16"] = {
            "rel_err_dx": rel_err(dx, dx_p), "rel_err_dw": rel_err(dw, dw_p),
            **bench(depthwise_bwd, [x, w, g]),
            "library_ms": graph_ms([lambda: library(g, x)] * 10),
            **bound_ms(3 * n * es + 2 * w.numel() * 4, 4 * k * k * n)}
        del x, g, dx, dw, dx_p, dw_p
        torch.cuda.empty_cache()
        rows.append(row)
        f4, f16, b16 = row[f"fwd{SERVE_BATCH}"], row[f"fwd{TRAIN_BATCH}"], row["bwd16"]
        print(f"{H}x{H} C={C} k={k} x{layers}: B3 b{SERVE_BATCH} {f4['ms']:.5f} (cold "
              f"{f4['cold_ms']:.5f}, bound {f4['bound_ms']:.5f}, library {f4['library_ms']:.5f}); "
              f"B3 b{TRAIN_BATCH} {f16['ms']:.5f} (cold {f16['cold_ms']:.5f}, bound "
              f"{f16['bound_ms']:.5f}, library {f16['library_ms']:.5f}); B4 b{TRAIN_BATCH} "
              f"{b16['ms']:.5f} (cold {b16['cold_ms']:.5f}, bound {b16['bound_ms']:.5f}, library "
              f"{b16['library_ms']:.5f}); rel err y {f4['rel_err']:.3g} dx "
              f"{b16['rel_err_dx']:.3g} dw {b16['rel_err_dw']:.3g}", flush=True)

    def total(key, field):
        return sum(r["layers"] * r[key][field] for r in rows)

    sums = {name: {field: total(key, field) for field in ("ms", "cold_ms", "bound_ms",
                                                          "library_ms")}
            for name, key in (("b3_per_served_forward", f"fwd{SERVE_BATCH}"),
                              ("b3_per_train_forward", f"fwd{TRAIN_BATCH}"),
                              ("b4_per_train_step", "bwd16"))}
    for name, s in sums.items():
        print(f"{name}: {s['ms']:.4f} ms (cold {s['cold_ms']:.4f}, bound {s['bound_ms']:.4f}, "
              f"library {s['library_ms']:.4f})", flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    result = {"dtype": "bf16", "card": smi, "device": torch.cuda.get_device_name(0),
              "rows": rows, "sums": sums, "sass": sass}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
