#!/usr/bin/env python3
"""Where the depthwise kernels' time goes: B3 / B4 built with parts taken out.

    python3 scripts/depthwise_ablation_torch.py [--variants base,empty,...] [--out FILE]

Needs one CUDA card and nvcc. Each variant is the kernels' sources
(``chexpert_tpu_torch/csrc/depthwise_{common.cuh,fwd.cu,bwd.cu}``) with a few
lines replaced, compiled with the flags ``chexpert_tpu_torch.kernels`` uses
into a temporary directory and called through its C entries directly:

* ``base``: the sources as they are;
* ``empty``: every block returns at once (the launch, and B4's torch sum);
* ``overhead``: no global loads, no compute, no stores: what is left is each
  block's set-up, its row tables, barriers and B4's dw reduction;
* ``no_compute``: loads and stores kept, the multiply-adds and shared reads
  taken out (the stores write zeros);
* ``no_loads``: the 16-byte copies replaced by zero fills of shared memory;
* ``no_stores``: the output stores never taken (the compute stays live).

Only ``base`` computes the right values; the others are timing probes. At the
ten stride-1 geometries of efficientnet-b4 at 380x380, bf16, it times B3 at
batch 4 and 16 and B4 at 16 by CUDA-graph replay of 10 calls (as
``scripts/bench_depthwise_torch.py`` does), prints one line per variant with
the sums over the 28 layers and the per-geometry times, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (H = W, C, k, layers) of efficientnet-b4's stride-1 depthwise layers at 380x380
GEOMETRIES = ((190, 48, 3, 1), (190, 24, 3, 1), (95, 192, 3, 3), (48, 336, 5, 3),
              (24, 672, 3, 5), (24, 672, 5, 1), (24, 960, 5, 5), (12, 1632, 5, 7),
              (12, 1632, 3, 1), (12, 2688, 3, 1))
SOURCES = ("depthwise_common.cuh", "depthwise_fwd.cu", "depthwise_bwd.cu")
NO_COMPUTE = ("for (int r = 0; r < R + K - 1; ++r) {", "for (int r = 0; r < 0; ++r) {")
NO_LOADS = ("while (sr < rows) {", "while (sr < 0) {")
NO_STORES = ("if (i + o < H) store_row(", "if (i + o < -H) store_row(")
VARIANTS = {
    "base": [],
    "empty": [("  const Tile t = tile_of(blockIdx.x, blockIdx.y, pl);",
               "  if (pl.p >= 0) return;\n  const Tile t = tile_of(blockIdx.x, blockIdx.y, pl);"),
              ("  const int cg = blockIdx.y;\n  const Item it = item_of(cg, pl, C);",
               "  if (pl.p >= 0) return;\n  const int cg = blockIdx.y;\n"
               "  const Item it = item_of(cg, pl, C);")],
    "overhead": [NO_COMPUTE, NO_LOADS, NO_STORES],
    "no_compute": [NO_COMPUTE],
    "no_loads": [("cp_async16(dst, src[k] + (e0 - off + q * VEC));",
                  "*reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);")],
    "no_stores": [NO_STORES],
}


def build(names, tmp: Path) -> dict:
    from chexpert_tpu_torch import kernels

    procs, libs = [], {}
    for name in names:
        d = tmp / name
        d.mkdir()
        for f in SOURCES:
            text = (kernels.CSRC_DIR / f).read_text()
            for old, new in VARIANTS[name]:
                text = text.replace(old, new)
            (d / f).write_text(text)
        for stem in ("depthwise_fwd", "depthwise_bwd"):
            lib = d / f"{stem}.so"
            procs.append((name, subprocess.Popen(
                [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(d / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            libs.setdefault(name, []).append(lib)
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
    return libs


def graph_ms(calls, reps: int = 10) -> float:
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
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("depthwise_ablation_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from chexpert_tpu_torch import kernels

    names = args.variants.split(",")
    texts = "".join((kernels.CSRC_DIR / f).read_text() for f in SOURCES)
    for name in names:
        for old, _ in VARIANTS[name]:
            if old not in texts:
                raise RuntimeError(f"variant {name}: {old!r} is not in the sources")
    gen = torch.Generator().manual_seed(3)
    data = []
    for H, C, k, n in GEOMETRIES:
        w = (torch.randn(C, 1, k, k, generator=gen) * 0.2).cuda()
        xs = {b: torch.randn(b, C, H, H, generator=gen).to("cuda", torch.bfloat16) for b in (4, 16)}
        g16 = torch.randn(16, C, H, H, generator=gen).to("cuda", torch.bfloat16)
        data.append((H, C, k, n, w, xs, g16))
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, Path(tmp))
        for name in names:
            fl, bl = (ctypes.CDLL(str(p)) for p in libs[name])
            fwd, bwd, n_part = fl.depthwise_fwd_bf16, bl.depthwise_bwd_bf16, bl.depthwise_bwd_n_part
            fwd.restype = bwd.restype = ctypes.c_int
            fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            n_part.restype, n_part.argtypes = ctypes.c_longlong, [ctypes.c_int] * 5
            rows = []
            for H, C, k, n, w, xs, g16 in data:
                def b3(x, w=w, k=k):
                    y = torch.empty_like(x)
                    kernels.check(fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), *x.shape, k,
                                      torch.cuda.current_stream().cuda_stream), "b3")
                    return y

                S = n_part(16, C, H, H, k)

                def b4(x=xs[16], g=g16, w=w, k=k, S=S, C=C, H=H):
                    dx = torch.empty_like(x)
                    part = torch.empty((S, C, k * k), device="cuda")
                    kernels.check(bwd(x.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                      part.data_ptr(), 16, C, H, H, k, S,
                                      torch.cuda.current_stream().cuda_stream), "b4")
                    return dx, part.sum(0)

                rows.append({"geometry": f"{H}x{H}", "C": C, "k": k, "layers": n,
                             "b3_b4_us": graph_ms([lambda: b3(xs[4])] * 10) * 1e3,
                             "b3_b16_us": graph_ms([lambda: b3(xs[16])] * 10) * 1e3,
                             "b4_b16_us": graph_ms([b4] * 10) * 1e3})
            sums = {key: sum(r["layers"] * r[key] for r in rows)
                    for key in ("b3_b4_us", "b3_b16_us", "b4_b16_us")}
            result[name] = {"sums": sums, "rows": rows}
            print(f"{name}: 28-layer sums, us: B3 b4 {sums['b3_b4_us']:.1f}, B3 b16 "
                  f"{sums['b3_b16_us']:.1f}, B4 b16 {sums['b4_b16_us']:.1f} | " + " | ".join(
                      f"{r['geometry']} C{r['C']} k{r['k']} {r['b3_b4_us']:.1f}/"
                      f"{r['b3_b16_us']:.1f}/{r['b4_b16_us']:.1f}" for r in rows), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    result["card"] = smi
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
