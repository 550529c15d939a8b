#!/usr/bin/env python3
"""Device time of the two attention backward kernels, pass by pass.

    python3 scripts/bench_attention_bwd_torch.py [--batch 16] [--dtype bf16] [--reps 10]
        [--geometries HxW[xDVH] ...] [--heads DKHxDVH[,...]] [--nh 8]

Needs one CUDA card. At the three attention geometries of a 320x320 input
(40x40 dvh 1, 20x20 dvh 3, 10x10 dvh 6; 8 heads, dkh 20) it runs B6
(``ops/hil_attention.py``: dkdv, dq, drel over the packed operand, slot
``hil_slot``) and B2 (``ops/fused_attention.py``: dkdv, dq over head-major
operands) once against their plain versions (largest error relative to the
largest entry), then times each pass by replaying a CUDA graph of it between
CUDA events. ``--heads`` times every head (dkh, dvh) of the list at every
map of ``--geometries`` instead (their dvh ignored), e.g. ``--batch 256 --nh 2
--geometries 8x8 --heads 320x128,150x75,128x64`` for the width rows of
chip_smoke.py's phase 19; ``--nh`` sets the heads per batch element.
Prints one line per row and, last, one JSON object with every number,
the per-step sums over aaresnet152's 47 attention layers (8 / 36 / 3) and
aadensenet121's 3 (one per geometry, default maps and heads only), and the
card's name and power limit. It also runs from a checkout of an earlier
commit of the port (whose dq pass returns the dRC rows alone), so two commits
can be timed in one run on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NH, DKH = 8, 20
GEOMETRIES = ((40, 40, 1), (20, 20, 3), (10, 10, 6))
AARESNET152_LAYERS = (8, 36, 3)
AADENSENET121_LAYERS = (1, 1, 1)


def device_ms(fn, reps: int, inner: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
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
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def bench_hil(H, W, dvh, batch, dtype, gen, reps, dkh=DKH, nh=NH):
    from chexpert_tpu_torch.ops import hil_attention as hil

    hw, slot = H * W, hil.hil_slot(dkh, dvh)
    geo = (H, W, dkh, dvh, slot)
    q = torch.randn(batch, hw, nh, dkh, generator=gen) * dkh ** -0.5
    k = torch.randn(batch, hw, nh, dkh, generator=gen)
    v = torch.randn(batch, hw, nh, dvh, generator=gen)
    pad = torch.zeros(batch, hw, nh, slot - 2 * dkh - dvh)
    P = torch.cat([q, k, v, pad], -1).reshape(batch, hw, nh * slot).to("cuda", dtype)
    Rw = hil.hil_rel_operand((torch.randn(dkh, 2 * W - 1, generator=gen)
                              + dkh ** -0.5).cuda(), W).contiguous()
    Rh = hil.hil_rel_operand((torch.randn(dkh, 2 * H - 1, generator=gen)
                              + dkh ** -0.5).cuda(), H).contiguous()
    out, lse = hil.hil_attention_fwd(P, Rw, Rh, *geo)
    dout = torch.randn(out.shape, generator=gen).to("cuda", dtype)
    got = hil.hil_attention_bwd(P, Rw, Rh, out, lse, dout, *geo)
    want = hil.hil_attention_bwd_plain(P, Rw, Rh, out, lse, dout, *geo)
    errs = {n: rel_err(g, w) for n, g, w in zip(("dP", "dRw", "dRh"), got, want)}
    delta = hil.hil_attention_delta(out, dout, nh)
    dP = torch.empty_like(P)
    args = (P, Rw, Rh, dout, lse, delta, dP, *geo)
    res = hil.hil_attention_bwd_dq(*args)
    drc, extra = (res[0], {"rc": res[1]}) if isinstance(res, tuple) else (res, {})
    return {"err": errs,
            "dkdv_ms": device_ms(lambda: hil.hil_attention_bwd_dkdv(*args, **extra), reps),
            "dq_ms": device_ms(lambda: hil.hil_attention_bwd_dq(*args), reps),
            "drel_ms": device_ms(lambda: hil.hil_attention_bwd_drel(P, drc, H, W, dkh, slot,
                                                                     dvh), reps)}


def bench_rel(H, W, dvh, batch, dtype, gen, reps, dkh=DKH, nh=NH):
    from chexpert_tpu_torch.ops import fused_attention as fa
    from chexpert_tpu_torch.ops.attention import pack_query

    hw, bn = H * W, batch * nh
    q = torch.randn(batch, nh, hw, dkh, generator=gen) * dkh ** -0.5
    k = torch.randn(bn, hw, dkh, generator=gen).to("cuda", dtype)
    v = torch.randn(bn, hw, dvh, generator=gen).to("cuda", dtype)
    rel_w = torch.randn(dkh, 2 * W - 1, generator=gen) + dkh ** -0.5
    rel_h = torch.randn(dkh, 2 * H - 1, generator=gen) + dkh ** -0.5
    qr = pack_query(q, rel_w, rel_h, H, W).reshape(bn, hw, -1).to("cuda", dtype).contiguous()
    out, lse = fa.rel_attention_fwd(qr, k, v, H, W, dkh)
    dout = torch.randn(out.shape, generator=gen).to("cuda", dtype)
    got = fa.rel_attention_bwd(qr, k, v, out, lse, dout, H, W, dkh)
    want = fa.rel_attention_bwd_plain(qr, k, v, out, lse, dout, H, W, dkh)
    errs = {n: rel_err(g, w) for n, g, w in zip(("dqr", "dk", "dv"), got, want)}
    args = (qr, k, v, dout, lse, fa.attention_delta(out, dout), H, W, dkh)
    return {"err": errs,
            "dkdv_ms": device_ms(lambda: fa.rel_attention_bwd_dkdv(*args), reps),
            "dq_ms": device_ms(lambda: fa.rel_attention_bwd_dq(*args), reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--geometries", nargs="+", metavar="HxW[xDVH]",
                    help="maps to time instead of the three of a 320x320 input, e.g. "
                         "16x16x4 8x8x8 (the CIFAR bench's WideResNet-28-10)")
    ap.add_argument("--heads", metavar="DKHxDVH[,...]",
                    help=f"heads to time at every map instead of dkh {DKH} and the map's dvh, "
                         "e.g. 160x64,320x128")
    ap.add_argument("--nh", type=int, default=NH, help="heads per batch element")
    a = ap.parse_args()
    maps = (GEOMETRIES if a.geometries is None
            else [tuple(int(x) for x in g.split("x")) for g in a.geometries])
    if a.heads is None:
        geos = [(g[0], g[1], g[2], DKH) for g in maps]
    else:
        heads = [tuple(int(x) for x in h.split("x")) for h in a.heads.split(",")]
        geos = [(g[0], g[1], dvh, dkh) for g in maps for dkh, dvh in heads]
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[a.dtype]
    gen = torch.Generator().manual_seed(5)
    rows = []
    for H, W, dvh, dkh in geos:
        row = {"geometry": f"{H}x{W}", "dkh": dkh, "dvh": dvh, "nh": a.nh,
               "b6": bench_hil(H, W, dvh, a.batch, dtype, gen, a.reps, dkh, a.nh),
               "b2": bench_rel(H, W, dvh, a.batch, dtype, gen, a.reps, dkh, a.nh)}
        rows.append(row)
        b6, b2 = row["b6"], row["b2"]
        print(f"{row['geometry']} ({dkh}, {dvh}) x {a.nh} heads {a.dtype} batch {a.batch}: "
              f"B6 dkdv {b6['dkdv_ms']:.4f} "
              f"dq {b6['dq_ms']:.4f} drel {b6['drel_ms']:.4f} ms, err "
              f"{ {n: float(f'{e:.3g}') for n, e in b6['err'].items()} }; B2 dkdv "
              f"{b2['dkdv_ms']:.4f} dq {b2['dq_ms']:.4f} ms, err "
              f"{ {n: float(f'{e:.3g}') for n, e in b2['err'].items()} }", flush=True)
        torch.cuda.empty_cache()

    def per_step(kernel, layers):
        return {p: sum(n * r[kernel][p] for n, r in zip(layers, rows))
                for p in rows[0][kernel] if p.endswith("_ms")}

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    sums = {} if a.geometries or a.heads or a.nh != NH else {
        "aaresnet152_step": {"b6": per_step("b6", AARESNET152_LAYERS),
                             "b2": per_step("b2", AARESNET152_LAYERS)},
        "aadensenet121_step": {"b2": per_step("b2", AADENSENET121_LAYERS)}}
    print(json.dumps({"card": smi, "dtype": a.dtype, "batch": a.batch, "rows": rows, **sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
