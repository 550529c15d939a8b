#!/usr/bin/env python3
"""Device time of the four attention kernels of one checkout of the port, at
chip_smoke.py's width rows, for an A/B of two commits on one card.

    python3 scripts/ab_attention_torch.py TREE OUT.json [--rows wide,class,zoo,f32] [--bwd]
        [--packs 1,2,3,...]
    python3 scripts/ab_attention_torch.py --summary OUT1.json OUT2.json ...

Needs one CUDA card. Imports the port from the checkout TREE (``.`` for
this one, or an earlier commit unpacked elsewhere with this file's sibling
``bench_attention_fwd_torch.py`` copied into its ``scripts/``) and times,
with the benches' own functions (``bench_attention_fwd_torch.bench_rel`` /
``bench_hil``: B1 / B5 beside scaled_dot_product_attention with the bias
materialized, on the head-major and the heads-in-lanes operands), bf16:

  * ``wide``: heads past (128, 64) at their maps, batch 256 x 2 heads:
    (160, 64) 16x16, (320, 128) 8x8, (150, 75) 8x8, (512, 256) 1x1;
  * ``class``: (24, 8), (26, 8), (32, 16), (20, 16), (64, 32), (128, 64) at
    16x16 and 8x8, batch 256 x 2 heads;
  * ``zoo``: dkh 20 at 40x40 / 20x20 / 10x10 (dvh 1, 3, 6), batch 16 x 8;
  * ``f32``: the first three wide rows in f32 (the CUDA-core route);
  * ``--bwd``: B2's and B6's passes at the wide rows
    (``bench_attention_bwd_torch``);
  * ``--packs``: B1 / B5 of (512, 256) at 1x1 and 2x2 and (256, 128) at 4x4
    with the wide forward's pack forced to each value
    (``fused_attention.fwd_pack``), where the checkout has one.

Run it for parent, change, change, parent in one call and ``--summary``
over the four files: the means of each side, the speed-up and SDPA's time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time

WIDE = [(16, 16, 64, 160), (8, 8, 128, 320), (8, 8, 75, 150), (1, 1, 256, 512)]
CLASS = [(n, n, dvh, dkh) for dkh, dvh in ((24, 8), (26, 8), (32, 16), (20, 16), (64, 32),
                                           (128, 64)) for n in (16, 8)]
ZOO = [(40, 40, 1, 20), (20, 20, 3, 20), (10, 10, 6, 20)]
PACK_ROWS = [(1, 1, 256, 512), (2, 2, 256, 512), (4, 4, 128, 256)]


def _load(tree: str, name: str):
    spec = importlib.util.spec_from_file_location(name, f"{tree}/scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(tree: str, out: str, groups, bwd: bool, packs) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    fwd = _load(tree, "bench_attention_fwd_torch")
    plan = []
    if "wide" in groups:
        plan += [(g, 256, 2, torch.bfloat16) for g in WIDE]
    if "class" in groups:
        plan += [(g, 256, 2, torch.bfloat16) for g in CLASS]
    if "zoo" in groups:
        plan += [(g, 16, 8, torch.bfloat16) for g in ZOO]
    if "f32" in groups:
        plan += [(g, 256, 2, torch.float32) for g in WIDE[:3]]
    gen = torch.Generator().manual_seed(7)
    t0 = time.time()
    rows = []
    for (H, W, dvh, dkh), batch, nh, dtype in plan:
        r = {"geometry": f"{H}x{W}", "dkh": dkh, "dvh": dvh, "batch": batch, "nh": nh,
             "dtype": str(dtype).replace("torch.", ""),
             "b5": fwd.bench_hil(H, W, dvh, batch, dtype, gen, 10, dkh, nh),
             "b1": fwd.bench_rel(H, W, dvh, batch, dtype, gen, 10, dkh, nh)}
        rows.append(r)
        print(f"{tree} fwd {r['geometry']} ({dkh}, {dvh}) x {batch}x{nh} {r['dtype']}: B1 "
              f"{r['b1']['ms']:.4f} (SDPA {r['b1']['library_ms']:.4f}, err {r['b1']['err']:.3g}) "
              f"B5 {r['b5']['ms']:.4f} (SDPA {r['b5']['library_ms']:.4f}, err "
              f"{r['b5']['err']:.3g})", flush=True)
        torch.cuda.empty_cache()
    bwd_rows = []
    if bwd:
        bb = _load(tree, "bench_attention_bwd_torch")
        gen = torch.Generator().manual_seed(5)
        for H, W, dvh, dkh in WIDE:
            r = {"geometry": f"{H}x{W}", "dkh": dkh, "dvh": dvh,
                 "b6": bb.bench_hil(H, W, dvh, 256, torch.bfloat16, gen, 10, dkh, 2),
                 "b2": bb.bench_rel(H, W, dvh, 256, torch.bfloat16, gen, 10, dkh, 2)}
            bwd_rows.append(r)
            print(f"{tree} bwd {r['geometry']} ({dkh}, {dvh}): B2 dkdv {r['b2']['dkdv_ms']:.4f} "
                  f"dq {r['b2']['dq_ms']:.4f}; B6 dq {r['b6']['dq_ms']:.4f} dkdv "
                  f"{r['b6']['dkdv_ms']:.4f} drel {r['b6']['drel_ms']:.4f}", flush=True)
            torch.cuda.empty_cache()
    pack_rows = []
    if packs:
        from chexpert_tpu_torch.ops import fused_attention as fa

        real = fa.fwd_pack
        for pack in packs:
            fa.fwd_pack = lambda H, W, *a, p=pack, **k: p if p * H * W <= fa.BW_ROWS else 1
            fa.fwd_plan_args.cache_clear()
            for H, W, dvh, dkh in PACK_ROWS:
                if pack * H * W > fa.BW_ROWS:
                    continue
                gen = torch.Generator().manual_seed(7)
                r = {"geometry": f"{H}x{W}", "dkh": dkh, "dvh": dvh, "pack": pack,
                     "b1": fwd.bench_rel(H, W, dvh, 256, torch.bfloat16, gen, 10, dkh, 2),
                     "b5": fwd.bench_hil(H, W, dvh, 256, torch.bfloat16, gen, 10, dkh, 2)}
                pack_rows.append(r)
                print(f"{tree} pack {pack} {r['geometry']} ({dkh}, {dvh}): B1 {r['b1']['ms']:.4f} "
                      f"B5 {r['b5']['ms']:.4f} (err {r['b1']['err']:.3g}, {r['b5']['err']:.3g})",
                      flush=True)
        fa.fwd_pack = real
        fa.fwd_plan_args.cache_clear()
    with open(out, "w") as f:
        json.dump({"tree": tree, "fwd": rows, "bwd": bwd_rows, "packs": pack_rows,
                   "card": subprocess.run(
                       ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
                   "s": time.time() - t0}, f)
    return 0


def summary(files) -> int:
    """Means of each side's runs (a file per run; its side from the name:
    ..._parent.json or ..._change.json) per row, and the parent / change
    ratio."""
    runs = {}
    for f in files:
        runs.setdefault("parent" if f.endswith("parent.json") else "change", []).append(
            json.load(open(f)))

    def mean(xs):
        return sum(xs) / len(xs)

    out = {"fwd": [], "bwd": []}
    for i, r0 in enumerate(runs["change"][0]["fwd"]):
        row = {"row": [r0["geometry"], r0["dkh"], r0["dvh"], r0["batch"], r0["nh"], r0["dtype"]]}
        for k in ("b1", "b5"):
            p = mean([r["fwd"][i][k]["ms"] for r in runs["parent"]])
            c = mean([r["fwd"][i][k]["ms"] for r in runs["change"]])
            row[k] = {"parent": p, "change": c, "x": p / c,
                      "sdpa": mean([r["fwd"][i][k]["library_ms"] for r in runs["change"]])}
        out["fwd"].append(row)
        print(row["row"], " ".join(f"{k.upper()} {row[k]['parent']:.4f} -> {row[k]['change']:.4f}"
                                   f" ({row[k]['x']:.2f}x, SDPA {row[k]['sdpa']:.4f})"
                                   for k in ("b1", "b5")))
    for i, r0 in enumerate(runs["change"][0]["bwd"]):
        row = {"row": [r0["geometry"], r0["dkh"], r0["dvh"]]}
        for k, ps in (("b2", ("dkdv_ms", "dq_ms")), ("b6", ("dq_ms", "dkdv_ms", "drel_ms"))):
            for p in ps:
                row[f"{k} {p}"] = [mean([r["bwd"][i][k][p] for r in runs[s]])
                                   for s in ("parent", "change")]
        out["bwd"].append(row)
        print(row)
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", nargs="?", help="the checkout to time")
    ap.add_argument("out", nargs="?", help="where to write its rows")
    ap.add_argument("--rows", default="wide", help="row groups: wide,class,zoo,f32")
    ap.add_argument("--bwd", action="store_true", help="B2's and B6's passes at the wide rows")
    ap.add_argument("--packs", default="", help="packs to force on the tiny maps, e.g. 1,2,3,4")
    ap.add_argument("--summary", nargs="+", metavar="OUT.json", help="summarize runs instead")
    a = ap.parse_args()
    if a.summary:
        return summary(a.summary)
    if not a.tree or not a.out:
        ap.error("TREE and OUT are required unless --summary is given")
    return run(a.tree, a.out, a.rows.split(","), a.bwd,
               [int(x) for x in a.packs.split(",") if x])


if __name__ == "__main__":
    sys.exit(main())
