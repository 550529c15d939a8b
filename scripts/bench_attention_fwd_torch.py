#!/usr/bin/env python3
"""Device time of the two attention forward kernels, B1 and B5, call by call.

    python3 scripts/bench_attention_fwd_torch.py [--batches 4 16] [--dtype bf16] [--reps 10]
        [--geometries HxW[xDVH] ...] [--heads DKHxDVH[,...]] [--nh 8]

Needs one CUDA card. At the three attention geometries of a 320x320 input
(40x40 dvh 1, 20x20 dvh 3, 10x10 dvh 6; 8 heads, dkh 20) and each batch it
runs B5 (``ops/hil_attention.py``, over the packed operand, slot
``hil_slot``: 48 there) and B1 (``ops/fused_attention.py``, head-major
operands) once against their plain versions (largest error of out and lse),
then times each by replaying a CUDA graph of it between CUDA events, beside
one library call of the same function (scaled_dot_product_attention with the
relative bias materialized beforehand; for B5 with the head-split copies of
q, k, v out of the packed operand and the head-merge copy of its output).
``--heads`` times every head (dkh, dvh) of the list at every map of
``--geometries`` instead (their dvh ignored), e.g. ``--batches 256 --nh 2
--geometries 16x16 8x8 1x1 --heads 160x64,320x128`` for the width rows of
chip_smoke.py's phase 19; ``--nh`` sets the heads per batch element.
Prints one line per row and, last, one JSON object with every number, the
per-forward sums over aaresnet152's 47 attention layers (8 / 36 / 3) and
aadensenet121's 3 (one per geometry; default maps and heads only), and the
card's name and power limit.
It calls only the wrappers' public functions, so it also runs from a
checkout of an earlier commit of the port: two commits can be timed in one
run on one card.
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


def max_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def bench_hil(H, W, dvh, batch, dtype, gen, reps, dkh=DKH, nh=NH):
    from chexpert_tpu_torch.ops import hil_attention as hil
    from chexpert_tpu_torch.ops.fused_attention import key_positions

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
    err = max_err(hil.hil_attention_fwd(P, Rw, Rh, *geo),
                  hil.hil_attention_fwd_plain(P, Rw, Rh, *geo))

    # the library call: the bias materialized from the f32 RC rows beforehand
    col, row = key_positions(hw, W, P.device)
    Pv = P.view(batch, hw, nh, slot).permute(0, 2, 1, 3)
    q2 = Pv[..., :dkh].float().reshape(batch, nh, H, W, dkh)
    rcw = torch.einsum("bnhwd,wdm->bnhwm", q2, Rw.view(W, dkh, W)).reshape(batch, nh, hw, W)
    rch = torch.einsum("bnhwd,hdm->bnhwm", q2, Rh.view(H, dkh, H)).reshape(batch, nh, hw, H)
    bias = (rcw[..., col] + rch[..., row]).to(dtype).contiguous()
    del q2, rcw, rch

    def library():
        qh, kh, vh = (Pv[..., a:b].contiguous()
                      for a, b in ((0, dkh), (dkh, 2 * dkh), (2 * dkh, 2 * dkh + dvh)))
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=1.0)
        return o.permute(0, 2, 1, 3).reshape(batch, hw, nh * dvh)

    return {"err": err, "ms": device_ms(lambda: hil.hil_attention_fwd(P, Rw, Rh, *geo), reps),
            "library_ms": device_ms(library, reps)}


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
    err = max_err(fa.rel_attention_fwd(qr, k, v, H, W, dkh),
                  fa.rel_attention_fwd_plain(qr, k, v, H, W, dkh))
    col, row = fa.key_positions(hw, W, qr.device)
    bias = (qr[..., dkh:dkh + W][..., col] + qr[..., dkh + W:][..., row]).contiguous()
    qq = qr[..., :dkh].contiguous()
    return {"err": err, "ms": device_ms(lambda: fa.rel_attention_fwd(qr, k, v, H, W, dkh), reps),
            "library_ms": device_ms(
                lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=bias, scale=1.0), reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 16])
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
    gen = torch.Generator().manual_seed(7)
    rows = []
    for batch in a.batches:
        for H, W, dvh, dkh in geos:
            row = {"geometry": f"{H}x{W}", "dkh": dkh, "dvh": dvh, "nh": a.nh, "batch": batch,
                   "b5": bench_hil(H, W, dvh, batch, dtype, gen, a.reps, dkh, a.nh),
                   "b1": bench_rel(H, W, dvh, batch, dtype, gen, a.reps, dkh, a.nh)}
            rows.append(row)
            b5, b1 = row["b5"], row["b1"]
            print(f"{row['geometry']} ({dkh}, {dvh}) x {a.nh} heads {a.dtype} batch {batch}: "
                  f"B5 {b5['ms']:.4f} ms (library {b5['library_ms']:.4f}, err {b5['err']:.3g}); "
                  f"B1 {b1['ms']:.4f} ms (library {b1['library_ms']:.4f}, err {b1['err']:.3g})",
                  flush=True)
            torch.cuda.empty_cache()

    def per_forward(batch, layers):
        these = [r for r in rows if r["batch"] == batch]
        return {kern: {key: sum(n * r[kern][key] for n, r in zip(layers, these))
                       for key in ("ms", "library_ms")} for kern in ("b5", "b1")}

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    sums = {} if a.geometries or a.heads or a.nh != NH else {
        "aaresnet152_forward": {f"batch{b}": per_forward(b, AARESNET152_LAYERS)
                                for b in a.batches},
        "aadensenet121_forward": {f"batch{b}": per_forward(b, AADENSENET121_LAYERS)
                                  for b in a.batches}}
    print(json.dumps({"card": smi, "dtype": a.dtype, "rows": rows, **sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
