#!/usr/bin/env python3
"""Smoke run of the PyTorch port (chexpert_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each failing the run on error:

1. build: compiles chexpert_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per source, all started together, and prints the card
   (nvidia-smi name, power limit).
2. kernel B1: the relative-position attention forward kernel at the three
   aadensenet121 320x320 transition geometries, batch 4 (bn = 32), against
   its plain PyTorch version on the card in f32 and bf16; times the kernel,
   the plain version and one library call of the same function
   (scaled_dot_product_attention with the relative bias materialized).
3. kernel B2: B1 and the backward kernel's two passes (dk/dv, then dq with
   the dRW/dRH bins) at the same geometries with bn = 128 (the training
   batch 16 x 8 heads), in f32 and bf16, against their plain versions; times
   each pass, its plain version, B1 at bn 128, and the backward of the
   library call with a bias that requires grad.
4. serve: aadensenet121 at 320x320 with seeded random weights, saved by the
   port's checkpoint store and served by chexpert_tpu_torch.cli.serve on the
   card in bf16; JPEG requests over HTTP; launch counts must show every
   forward went through B1 (3 launches per forward) and none through B2;
   the f32 kernel path must agree with the f32 einsum path within 1e-3 in
   probability and 1e-4 in logits (relative to the largest).
5. train: the port's synthetic fixture at 320x320, then
   chexpert_tpu_torch.cli.chexpert.main --train --evaluate_single_model,
   aadensenet121, bf16 autocast, batch 16, on one repeated batch (16 train
   images, one step per epoch) at lr 0.01 (SGD-Nesterov, the arch's
   optimizer; a CPU rehearsal at 96x96 fell monotonically at this lr):
   every loss finite, the last step's loss below the first, 3 B1 + 3 of
   each B2 pass per train step and 3 B1 per eval forward, and the run's
   artifacts written; prints ms/step and images/s.
6. grad reference: one f32 train step at batch 4, 320x320, TF32 off, from
   the same weights and batch on the kernel route and on the einsum route.
   Per AA transition, on its captured input and upstream gradient: every
   gradient, the relative embeddings and qkv projection included, within
   max |dg| / max |g| <= 1e-3. The whole model's gradients are reported,
   not gated (see grad_reference_phase).
7. kernel B3/B4: the depthwise conv forward kernel and the backward kernel
   at the ten distinct stride-1 geometries of efficientnet-b4 at 380x380
   (derived from the port's scaled_blocks and checked against the list
   below), in f32 and bf16: B3 at batch 4 (serving) and 16 (training), B4
   at 16, each against its plain version; times each beside its plain
   version and one library call (F.conv2d(groups=C) for B3,
   aten.convolution_backward for dx and dw for B4), by device time (the
   calls captured in a CUDA graph and replayed between CUDA events), with
   the wrapper's and the library call's eager time beside it.
8. serve efficientnet-b4 at 380x380, bf16, micro-batch 4, seeded random
   weights with BatchNorm statistics set from the request images
   (calibrate_bn), over HTTP as in phase 4: 28 B3 launches per forward and
   no other kernel; the f32 kernel route within 1e-3 (probabilities) and
   1e-4 (logits) of the f32 library route (dw_impl="library").
9. train efficientnet-b4 through cli.chexpert.main as in phase 5, 380x380,
   bf16, batch 16, RMSprop + per-step exponential decay at lr 3e-4 (a CPU
   rehearsal at 96x96 and 192x192 fell at this lr): finite, falling loss,
   28 B3 + 28 B4 launches per train step and 28 B3 per eval forward, the
   run's artifacts; prints ms/step and images/s.
10. depthwise grad reference: one f32 train step of efficientnet-b4 at
   batch 4, 380x380, TF32 off, on the kernel route and on the library route
   from the same weights, batch and generator seed. Per stride-1 depthwise
   layer, on its captured input and upstream gradient: dx and dw within
   max |dg| / max |g| <= 1e-3. The whole model's gradients are reported.

11. kernel B5/B6: the heads-in-lanes attention forward kernel and the
   backward's three passes (dk/dv, dq with the dRC rows, dRw/dRh) at the
   three AA geometries of 320x320 (40x40 dvh 1, 20x20 dvh 3, 10x10 dvh 6; 8
   heads, dkh 20, slot 48) over the packed operand, in f32 and bf16: B5 at
   batch 4 and 16, B6 at 16, against their plain versions (out, lse; every
   lane of dP, the pad lanes exactly 0; dRw, dRh); device time of each
   beside its plain version, its bound, the library call
   (scaled_dot_product_attention with the bias materialized, the head-split
   and head-merge copies from and to the packed layout included) and B1 /
   B2 at the same geometry and batch.
12. serve aaresnet152 (Bottleneck (3, 8, 36, 3), 47 AA convs) at 320x320,
   bf16, micro-batch 4, over HTTP as in phase 4, once under
   CHEXPERT_ATTN_LAYOUT=hil (47 B5 launches per forward and no other
   kernel) and once under bn (47 B1 and no other); each layout's f32 kernel
   route against the f32 einsum route as in phase 4. The seeded weights are
   made servable first: BatchNorm statistics from the requests
   (calibrate_bn) and damped residual branches (damp_residuals).
13. train aaresnet152 through cli.chexpert.main as in phase 5, 320x320,
   bf16, batch 16, Adam at lr 1e-4 (a CPU rehearsal at 64x64 fell at this
   lr), layout hil: finite, falling loss, 47 B5 + 47 of each B6 pass per
   train step and 47 B5 per eval forward, nothing else; prints ms/step and
   images/s. Then three steps under bn: 47 B1 + 47 of each B2 pass per step.
14. aaresnet152 grad reference: as phase 6 with the hil route against the
   einsum route, over all 47 AA convs on their captured inputs and upstream
   gradients: every gradient within 1e-3; whole model reported.

The phases take about 110 s on an H100, the build included (the run prints
its own time). The last lines are one {"kernels": [...]} JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is available or the port is not importable.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
IMAGE = 320                                # input size; the geometries below follow it
B, NH, DKH = 4, 8, 20                      # serving micro-batch, heads, head width
B_TRAIN = 16                               # training batch (the CLI default)
GEOMETRIES = ((40, 40, 1), (20, 20, 3), (10, 10, 6))  # (H, W, dvh) at 320x320
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor bf16; f32 non-tensor
# f32: the same f32 algorithm on both sides; online-softmax rescaling and the
# summation order differ, worth ~1e-6 relative on lse ~ 10: 1e-4 leaves margin.
# bf16: both read the same bf16 operands and accumulate in f32; the output is
# rounded to bf16, one ulp of which is 1.6e-2 just below 4: 2e-2 covers one
# rounding flip of |out| < 4 (out is a convex mix of N(0,1) values).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# B2, on max |kernel - plain| / max(1, max |plain|) per output (dqr, dk, dv):
# f32, the same f32 algorithm summed in another order over up to 1600 keys;
# bf16, both sides round their f32 result to bf16, one ulp of which is at
# most 2^-7 of the largest value.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
EINSUM_TOL = 1e-3                          # f32 kernel route vs f32 einsum / library route
# the same routes' logits, max |d| / max |logit|: two f32 routes over the
# same weights differ only in the order of f32 sums (~1e-7 relative per
# layer; measured 4e-7 for aadensenet121 and 0 for efficientnet-b4 on an
# H100), while the probability gate alone is loose where every probability
# sits near 0.5 (a 1e-3 step there is ~4e-3 in logit)
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-3                            # f32 grads, kernel route vs einsum route
N_REQUESTS = 8
TRAIN_STEPS, TRAIN_LR, EVAL_INTERVAL = 6, 0.01, 3

EFF, EFF_IMAGE = "efficientnet-b4", 380    # its own resolution in SCALING_PARAMS
EFF_TRAIN_LR = 3e-4                        # RMSprop, eps 1e-3: see phase 9 above
# (H = W, C, k) of efficientnet-b4's stride-1 depthwise layers at 380x380
DW_GEOMETRIES = ((190, 48, 3), (190, 24, 3), (95, 192, 3), (48, 336, 5), (24, 672, 3),
                 (24, 672, 5), (24, 960, 5), (12, 1632, 5), (12, 1632, 3), (12, 2688, 3))
DW_LAYERS = 28
# B3 / B4 against their plain versions, max |kernel - plain| / max |plain|:
# y and dx, f32 1e-5 (the same f32 sums of k*k terms in another order);
# bf16 1e-2 (both round the same f32 sum to bf16, one ulp of which is 2^-8
# of the largest value); dw is an f32 sum over up to 16*190*190 terms in
# both dtypes, summed per block and then over blocks: 1e-4.
DW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DW_W_TOL = 1e-4

AA_RES = "aaresnet152"                     # Bottleneck (3, 8, 36, 3), AA convs on layers 2-4
# its AA convs per (H, W, dvh) of GEOMETRIES at 320x320: the blocks of layers 2 / 3 / 4
AA_LAYERS = {(40, 40, 1): 8, (20, 20, 3): 36, (10, 10, 6): 3}
N_AA = 47
AA_TRAIN_LR = 1e-4                         # Adam: a CPU rehearsal at 64x64 fell 3.85 -> 2.45 in 5 steps
AA_REQUESTS = 4
AA_RESIDUAL_GAMMA = 0.25                   # the served model's residual scale: see damp_residuals
AA_TRAIN_STEPS_BN = 3                      # the bn layout's train run only gates its launches
LAYOUT_ENV = "CHEXPERT_ATTN_LAYOUT"        # read once by build_model, as the JAX package names it


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


@contextlib.contextmanager
def attn_layout_env(layout):
    """Set the attention layout switch that the entry points read (None:
    leave it unset, the default layout) and restore it afterwards."""
    old = os.environ.pop(LAYOUT_ENV, None)
    if layout is not None:
        os.environ[LAYOUT_ENV] = layout
    try:
        yield
    finally:
        os.environ.pop(LAYOUT_ENV, None)
        if old is not None:
            os.environ[LAYOUT_ENV] = old


def time_ms(fn, reps: int = 15, inner: int = 5) -> float:
    """Median over reps of CUDA-event time per call (inner calls per rep)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 10, inner: int = 10) -> float:
    """Median over reps of the device time per call: inner calls captured in
    one CUDA graph and replayed between CUDA events, so the host's work per
    call (Python, the wrapper, the dispatcher) is not in it."""
    fn()  # lazy initialisation and library planning, outside the capture
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
    del graph
    return statistics.median(times)


def kernel_inputs(H, W, dvh, dtype, gen, batch=B):
    from chexpert_tpu_torch.ops.attention import pack_query

    hw, bn = H * W, batch * NH
    q = torch.randn(batch, NH, hw, DKH, generator=gen) * DKH ** -0.5
    k = torch.randn(bn, hw, DKH, generator=gen)
    v = torch.randn(bn, hw, dvh, generator=gen)
    rel_w = torch.randn(DKH, 2 * W - 1, generator=gen) + DKH ** -0.5
    rel_h = torch.randn(DKH, 2 * H - 1, generator=gen) + DKH ** -0.5
    qr = pack_query(q, rel_w, rel_h, H, W).reshape(bn, hw, DKH + W + H)
    return [t.to(DEVICE, dtype).contiguous() for t in (qr, k, v)]


def bound(nbytes: float, flops: float, dtype) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kernel_phase():
    from chexpert_tpu_torch.ops.fused_attention import (
        key_positions,
        rel_attention_fwd,
        rel_attention_fwd_plain,
    )

    gen = torch.Generator().manual_seed(0)
    rows = []
    for H, W, dvh in GEOMETRIES:
        hw = H * W
        for dtype in (torch.float32, torch.bfloat16):
            qr, k, v = kernel_inputs(H, W, dvh, dtype, gen)
            out, lse = rel_attention_fwd(qr, k, v, H, W, DKH)
            torch.cuda.synchronize()
            out_p, lse_p = rel_attention_fwd_plain(qr, k, v, H, W, DKH)
            err_out = (out.float() - out_p.float()).abs().max().item()
            err_lse = (lse - lse_p).abs().max().item()
            ok = bool(torch.isfinite(out.float()).all()) and max(err_out, err_lse) <= TOL[dtype]
            col, row = key_positions(hw, W, qr.device)
            bias = (qr[..., DKH:DKH + W][..., col] + qr[..., DKH + W:][..., row]).contiguous()
            q = qr[..., :DKH].contiguous()

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)

            err_lib = (library().float() - out_p.float()).abs().max().item()
            es = qr.element_size()
            nbytes = (qr.numel() + k.numel() + v.numel() + out.numel()) * es + lse.numel() * 4
            flops = B * NH * hw * hw * (2 * DKH + 2 + 3 + 2 * dvh)
            rows.append({
                "geometry": f"{H}x{W}", "hw": hw, "bn": B * NH, "dkh": DKH, "dvh": dvh,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err_out": err_out, "max_abs_err_lse": err_lse, "tol": TOL[dtype],
                "library_max_abs_err": err_lib,
                "kernel_ms": time_ms(lambda: rel_attention_fwd(qr, k, v, H, W, DKH)),
                "plain_ms": time_ms(lambda: rel_attention_fwd_plain(qr, k, v, H, W, DKH)),
                "library_ms": time_ms(library),
                **bound(nbytes, flops, dtype),
                "ok": ok,
            })
            print(f"kernel rel_attention_fwd {H}x{W} dvh={dvh} {rows[-1]['dtype']}: "
                  f"err out {err_out:.3g} lse {err_lse:.3g} (tol {TOL[dtype]}) "
                  f"kernel {rows[-1]['kernel_ms']:.4f} ms plain {rows[-1]['plain_ms']:.4f} ms "
                  f"library {rows[-1]['library_ms']:.4f} ms", flush=True)
            del qr, k, v, bias, q
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return rows


def bwd_kernel_phase():
    """B2's two passes against the plain backward at the training geometry."""
    from chexpert_tpu_torch.ops.fused_attention import (
        attention_delta,
        key_positions,
        rel_attention_bwd,
        rel_attention_bwd_dkdv,
        rel_attention_bwd_dkdv_plain,
        rel_attention_bwd_dq,
        rel_attention_bwd_dq_plain,
        rel_attention_bwd_plain,
        rel_attention_fwd,
        rel_attention_fwd_plain,
    )

    gen = torch.Generator().manual_seed(1)
    bn = B_TRAIN * NH
    rows = []
    for H, W, dvh in GEOMETRIES:
        hw, L = H * W, DKH + W + H
        for dtype in (torch.float32, torch.bfloat16):
            qr, k, v = kernel_inputs(H, W, dvh, dtype, gen, batch=B_TRAIN)
            # B1 at the training grid, held to its plain version as in kernel_phase
            out, lse = rel_attention_fwd(qr, k, v, H, W, DKH)
            torch.cuda.synchronize()
            out_p, lse_p = rel_attention_fwd_plain(qr, k, v, H, W, DKH)
            fwd_err = {"out": (out.float() - out_p.float()).abs().max().item(),
                       "lse": (lse - lse_p).abs().max().item()}
            fwd_ok = (bool(torch.isfinite(out.float()).all())
                      and max(fwd_err.values()) <= TOL[dtype])
            del out_p, lse_p
            dout = torch.randn(out.shape, generator=gen).to(DEVICE, dtype)
            got = rel_attention_bwd(qr, k, v, out, lse, dout, H, W, DKH)
            torch.cuda.synchronize()
            want = rel_attention_bwd_plain(qr, k, v, out, lse, dout, H, W, DKH)
            errs, rel = {}, {}
            for name, g, w in zip(("dqr", "dk", "dv"), got, want):
                errs[name] = (g.float() - w.float()).abs().max().item()
                rel[name] = errs[name] / max(1.0, w.float().abs().max().item())
            ok = (all(bool(torch.isfinite(g.float()).all()) for g in got)
                  and max(rel.values()) <= BWD_TOL[dtype])
            delta = attention_delta(out, dout)
            args = (qr, k, v, dout, lse, delta, H, W, DKH)

            # library yardstick: SDPA's backward w.r.t. q, k, v and a materialized bias
            col, row = key_positions(hw, W, qr.device)
            bias = (qr[..., DKH:DKH + W][..., col] + qr[..., DKH + W:][..., row]).detach()
            leaves = [t.detach().clone().requires_grad_()
                      for t in (qr[..., :DKH].contiguous(), k, v, bias)]
            lib_out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)

            def library():
                return torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)

            es = qr.element_size()
            pairs = bn * hw * hw
            ins = (qr.numel() + k.numel() + v.numel() + dout.numel()) * es + 2 * bn * hw * 4
            rows.append({
                "geometry": f"{H}x{W}", "hw": hw, "bn": bn, "dkh": DKH, "dvh": dvh,
                "dtype": str(dtype).replace("torch.", ""), "abs_err": errs, "rel_err": rel,
                "tol": BWD_TOL[dtype], "ok": ok and fwd_ok,
                "fwd_abs_err": fwd_err, "fwd_tol": TOL[dtype], "fwd_ok": fwd_ok,
                "dkdv_ms": time_ms(lambda: rel_attention_bwd_dkdv(*args)),
                "dq_ms": time_ms(lambda: rel_attention_bwd_dq(*args)),
                "dkdv_plain_ms": time_ms(lambda: rel_attention_bwd_dkdv_plain(*args)),
                "dq_plain_ms": time_ms(lambda: rel_attention_bwd_dq_plain(*args)),
                "fwd_ms": time_ms(lambda: rel_attention_fwd(qr, k, v, H, W, DKH)),
                "library_ms": time_ms(library),
                # pass 1 per (query, key): S 2*dkh+2, exp 2, dp and dv 4*dvh, ds 2, dk 2*dkh
                "dkdv": bound(ins + (k.numel() + v.numel()) * es,
                              pairs * (4 * DKH + 4 * dvh + 6), dtype),
                # pass 2: S 2*dkh+2, exp 2, dp 2*dvh, ds 2, dq 2*dkh, the two bins 2
                "dq": bound(ins + bn * hw * L * es, pairs * (4 * DKH + 2 * dvh + 8), dtype),
                # the whole backward as one function of (qr, k, v, out, lse, dout)
                "b2": bound((qr.numel() + k.numel() + v.numel() + 2 * out.numel()) * es
                            + bn * hw * 4 + (qr.numel() + k.numel() + v.numel()) * es,
                            pairs * (6 * DKH + 4 * dvh + 8), dtype),
            })
            r = rows[-1]
            print(f"kernel rel_attention_bwd {H}x{W} dvh={dvh} bn={bn} {r['dtype']}: rel err "
                  f"{ {n: float(f'{e:.3g}') for n, e in rel.items()} } (tol {r['tol']}) "
                  f"dkdv {r['dkdv_ms']:.4f} ms (plain {r['dkdv_plain_ms']:.4f}) "
                  f"dq {r['dq_ms']:.4f} ms (plain {r['dq_plain_ms']:.4f}) library bwd "
                  f"{r['library_ms']:.4f} ms; bound dkdv {r['dkdv']['bound_ms']:.5f} "
                  f"dq {r['dq']['bound_ms']:.5f} ms; B1 at bn {bn} {r['fwd_ms']:.4f} ms, "
                  f"err out {fwd_err['out']:.3g} lse {fwd_err['lse']:.3g} (tol {TOL[dtype]})",
                  flush=True)
            del qr, k, v, out, lse, dout, got, want, leaves, lib_out, bias
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B1 or B2 disagrees with its plain version at bn {bn}: {bad}")
    return rows


def dw_stride1_layers(model: str, image: int):
    """(H, C, k) of each stride-1 depthwise layer of an EfficientNet variant
    at image x image, walked from the port's scaled_blocks and TF-SAME rule."""
    from chexpert_tpu_torch.models.efficientnet import scaled_blocks

    _, blocks, _ = scaled_blocks(model)
    h, layers = -(-image // 2), []  # after the stride-2 stem
    for n, cin, cout, k, s, e, _ in blocks:
        for i in range(n):
            stride, c = (s if i == 0 else 1), (cin if i == 0 else cout) * e
            if stride == 1:
                layers.append((h, c, k))
            else:
                h = -(-h // stride)  # TF-SAME: ceil(h / stride)
    return layers


def dw_kernel_phase():
    """B3 at the serving (4) and training (16) batch and B4 at the training
    batch, at every distinct stride-1 geometry of efficientnet-b4 at 380x380,
    in f32 and bf16, against their plain versions; times beside one library
    call each."""
    from chexpert_tpu_torch.ops.depthwise import (
        depthwise_bwd,
        depthwise_bwd_plain,
        depthwise_fwd,
        depthwise_fwd_plain,
    )

    layers = dw_stride1_layers(EFF, EFF_IMAGE)
    mult = {geo: layers.count(geo) for geo in DW_GEOMETRIES}
    if len(layers) != DW_LAYERS or set(layers) != set(DW_GEOMETRIES):
        raise AssertionError(f"{EFF} at {EFF_IMAGE}: stride-1 layers {layers} are not the "
                             f"{DW_LAYERS} layers over {DW_GEOMETRIES}")
    gen = torch.Generator().manual_seed(2)
    rows = []

    def errs(got, want):  # (max |got - want|, that over max |want|)
        d = (got.float() - want.float()).abs().max().item()
        return d, d / max(want.float().abs().max().item(), 1e-30)

    for H, C, k in DW_GEOMETRIES:
        p = k // 2
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.finfo(dtype).bits // 8
            w = (torch.randn(C, 1, k, k, generator=gen) * 0.2).to(DEVICE)
            w_lib = w.to(dtype)
            row = {"geometry": f"{H}x{H}", "C": C, "k": k, "layers": mult[(H, C, k)],
                   "dtype": str(dtype).replace("torch.", ""), "tol": DW_TOL[dtype],
                   "dw_tol": DW_W_TOL}
            for batch in (B, B_TRAIN):
                x = torch.randn(batch, C, H, H, generator=gen).to(DEVICE, dtype)
                y = depthwise_fwd(x, w)
                torch.cuda.synchronize()
                n = x.numel()
                abs_err, rel_err = errs(y, depthwise_fwd_plain(x, w))

                def library():
                    return F.conv2d(x, w_lib, padding=p, groups=C)

                row[f"fwd{batch}"] = {
                    "abs_err": abs_err, "rel_err": rel_err,
                    "ms": device_ms(lambda: depthwise_fwd(x, w)),
                    "plain_ms": device_ms(lambda: depthwise_fwd_plain(x, w)),
                    "library_ms": device_ms(library),
                    # eager calls between events: at these sizes the host's work
                    "host_ms": time_ms(lambda: depthwise_fwd(x, w)),
                    "library_host_ms": time_ms(library),
                    # x read and y written once, w (f32 rows) read once; 2 k^2 per output
                    # at the f32 rate outside the tensor cores (no tensor-core work)
                    **bound(2 * n * es + w.numel() * 4, 2 * k * k * n, torch.float32),
                }
                del y
            g = torch.randn(x.shape, generator=gen).to(DEVICE, dtype)  # x: the training batch
            dx, dw = depthwise_bwd(x, w, g)
            torch.cuda.synchronize()
            dx_p, dw_p = depthwise_bwd_plain(x, w, g)

            def library():
                return torch.ops.aten.convolution_backward(
                    g, x, w_lib, None, [1, 1], [p, p], [1, 1], False, [0, 0], C,
                    [True, True, False])

            (abs_dx, rel_dx), (abs_dw, rel_dw) = errs(dx, dx_p), errs(dw, dw_p)
            row["bwd16"] = {
                "abs_err_dx": abs_dx, "rel_err_dx": rel_dx, "abs_err_dw": abs_dw,
                "rel_err_dw": rel_dw,
                "ms": device_ms(lambda: depthwise_bwd(x, w, g)),
                "plain_ms": device_ms(lambda: depthwise_bwd_plain(x, w, g)),
                "library_ms": device_ms(library),
                "host_ms": time_ms(lambda: depthwise_bwd(x, w, g)),
                "library_host_ms": time_ms(library),
                # x, g read and dx written once, w read and dw written once (f32);
                # 2 k^2 per element for dx and 2 k^2 for dw
                **bound(3 * n * es + 2 * w.numel() * 4, 4 * k * k * n, torch.float32),
            }
            fwd_ok = all(row[f"fwd{b}"]["rel_err"] <= DW_TOL[dtype] for b in (B, B_TRAIN))
            bwd = row["bwd16"]
            row["ok"] = (fwd_ok and bwd["rel_err_dx"] <= DW_TOL[dtype]
                         and bwd["rel_err_dw"] <= DW_W_TOL
                         and bool(torch.isfinite(dx.float()).all()))
            rows.append(row)
            f4, f16 = row[f"fwd{B}"], row[f"fwd{B_TRAIN}"]
            print(f"kernel depthwise {H}x{H} C={C} k={k} x{row['layers']} {row['dtype']}: rel err "
                  f"y {f4['rel_err']:.3g}/{f16['rel_err']:.3g} dx {bwd['rel_err_dx']:.3g} "
                  f"dw {bwd['rel_err_dw']:.3g}; device ms: B3 b{B} {f4['ms']:.4f} (plain "
                  f"{f4['plain_ms']:.4f}, library {f4['library_ms']:.4f}, bound "
                  f"{f4['bound_ms']:.5f}); B3 b{B_TRAIN} {f16['ms']:.4f} (library "
                  f"{f16['library_ms']:.4f}); B4 b{B_TRAIN} {bwd['ms']:.4f} (plain "
                  f"{bwd['plain_ms']:.4f}, library {bwd['library_ms']:.4f}, bound "
                  f"{bwd['bound_ms']:.5f}); eager ms B3 b{B} {f4['host_ms']:.4f} (library "
                  f"{f4['library_host_ms']:.4f}), B4 {bwd['host_ms']:.4f} (library "
                  f"{bwd['library_host_ms']:.4f})", flush=True)
            del x, g, dx, dw, dx_p, dw_p
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B3 or B4 disagrees with its plain version: {bad}")
    return rows


def hil_kernel_phase():
    """B5 at the serving (4) and training (16) batch and B6's three passes at
    the training batch, at the three AA geometries of 320x320 (8 heads, dkh
    20, the model's slot stride), in f32 and bf16, against their plain
    versions: out and lse; every lane of dP (pad lanes exactly 0), dRw, dRh.
    Device time (CUDA-graph replay) of each kernel, its plain version and the
    library call: scaled_dot_product_attention with the relative bias
    materialized beforehand, the head-split copies of q, k, v out of P0 and
    the head-merge copy of its output included, since the layout exists to
    avoid those; its backward by events around eager calls. B1 and B2's two
    passes at the same geometry and batch, device time, beside them."""
    from chexpert_tpu_torch.ops.fused_attention import (
        attention_delta,
        key_positions,
        rel_attention_bwd_dkdv,
        rel_attention_bwd_dq,
        rel_attention_fwd,
    )
    from chexpert_tpu_torch.ops.hil_attention import (
        hil_attention_bwd,
        hil_attention_bwd_dkdv,
        hil_attention_bwd_dkdv_plain,
        hil_attention_bwd_dq,
        hil_attention_bwd_dq_plain,
        hil_attention_bwd_drel,
        hil_attention_bwd_drel_plain,
        hil_attention_bwd_plain,
        hil_attention_delta,
        hil_attention_fwd,
        hil_attention_fwd_plain,
        hil_rel_operand,
        hil_slot,
    )

    gen = torch.Generator().manual_seed(3)
    slow = {"reps": 5, "inner": 3}  # the plain versions and the backward at 40x40
    rows = []
    for H, W, dvh in GEOMETRIES:
        hw, slot = H * W, hil_slot(DKH, dvh)
        geo = (H, W, DKH, dvh, slot)
        col, krow = key_positions(hw, W, DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.finfo(dtype).bits // 8
            q = torch.randn(B_TRAIN, hw, NH, DKH, generator=gen) * DKH ** -0.5
            k = torch.randn(B_TRAIN, hw, NH, DKH, generator=gen)
            v = torch.randn(B_TRAIN, hw, NH, dvh, generator=gen)
            pad = torch.zeros(B_TRAIN, hw, NH, slot - 2 * DKH - dvh)
            P16 = torch.cat([q, k, v, pad], -1).reshape(B_TRAIN, hw, NH * slot).to(DEVICE, dtype)
            rel_w = (torch.randn(DKH, 2 * W - 1, generator=gen) + DKH ** -0.5).to(DEVICE)
            rel_h = (torch.randn(DKH, 2 * H - 1, generator=gen) + DKH ** -0.5).to(DEVICE)
            Rw = hil_rel_operand(rel_w, W).contiguous()
            Rh = hil_rel_operand(rel_h, H).contiguous()
            rel_bytes = (Rw.numel() + Rh.numel()) * 4
            row = {"geometry": f"{H}x{W}", "H": H, "W": W, "hw": hw, "nh": NH, "dkh": DKH,
                   "dvh": dvh, "slot": slot, "layers": AA_LAYERS[(H, W, dvh)],
                   "dtype": str(dtype).replace("torch.", ""), "tol": TOL[dtype],
                   "bwd_tol": BWD_TOL[dtype]}

            def heads(P):  # head-major views (batch, nh, hw, .) of the packed operand
                Pv = P.view(P.shape[0], hw, NH, slot).permute(0, 2, 1, 3)
                return Pv[..., :DKH], Pv[..., DKH:2 * DKH], Pv[..., 2 * DKH:2 * DKH + dvh]

            def library_fwd(P, bias):
                qh, kh, vh = (t.contiguous() for t in heads(P))  # the head-split copies
                o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=1.0)
                return o.permute(0, 2, 1, 3).reshape(P.shape[0], hw, NH * dvh)  # the merge copy

            for batch in (B, B_TRAIN):
                P = P16[:batch].contiguous()
                out, lse = hil_attention_fwd(P, Rw, Rh, *geo)
                torch.cuda.synchronize()
                out_p, lse_p = hil_attention_fwd_plain(P, Rw, Rh, *geo)
                q2 = heads(P)[0].float().reshape(batch, NH, H, W, DKH)
                rcw = torch.einsum("bnhwd,wdm->bnhwm", q2, Rw.view(W, DKH, W))
                rch = torch.einsum("bnhwd,hdm->bnhwm", q2, Rh.view(H, DKH, H))
                bias = (rcw.reshape(batch, NH, hw, W)[..., col]
                        + rch.reshape(batch, NH, hw, H)[..., krow]).to(dtype).contiguous()
                del q2, rcw, rch
                tok = batch * NH * hw
                row[f"fwd{batch}"] = {
                    "abs_err_out": (out.float() - out_p.float()).abs().max().item(),
                    "abs_err_lse": (lse - lse_p).abs().max().item(),
                    "finite": bool(torch.isfinite(out.float()).all()),
                    "library_abs_err": (library_fwd(P, bias).float()
                                        - out_p.float()).abs().max().item(),
                    "ms": device_ms(lambda: hil_attention_fwd(P, Rw, Rh, *geo)),
                    "plain_ms": device_ms(lambda: hil_attention_fwd_plain(P, Rw, Rh, *geo),
                                          **slow),
                    "library_ms": device_ms(lambda: library_fwd(P, bias)),
                    "host_ms": time_ms(lambda: hil_attention_fwd(P, Rw, Rh, *geo)),
                    # P, Rw, Rh read and out, lse written once; per (query, key) S 2*dkh+2,
                    # max/exp/sum 3, p.v 2*dvh; per RC entry 2*dkh
                    **bound(P.numel() * es + rel_bytes + out.numel() * es + lse.numel() * 4,
                            tok * hw * (2 * DKH + 2 + 3 + 2 * dvh) + tok * (W + H) * 2 * DKH,
                            dtype),
                }
                del out_p, lse_p
            # batch == B_TRAIN from here on: P, out, lse, bias are the training batch's
            dout = torch.randn(out.shape, generator=gen).to(DEVICE, dtype)
            got = hil_attention_bwd(P, Rw, Rh, out, lse, dout, *geo)
            torch.cuda.synchronize()
            want = hil_attention_bwd_plain(P, Rw, Rh, out, lse, dout, *geo)
            errs, rel = {}, {}
            for name, g, w in zip(("dP", "dRw", "dRh"), got, want):
                errs[name] = (g.float() - w.float()).abs().max().item()
                rel[name] = errs[name] / max(1.0, w.float().abs().max().item())
            pads = got[0].view(B_TRAIN, hw, NH, slot)[..., 2 * DKH + dvh:]
            pads_zero = int(torch.count_nonzero(pads)) == 0
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            del got, want

            delta = hil_attention_delta(out, dout, NH)
            dP = torch.empty_like(P)
            args = (P, Rw, Rh, dout, lse, delta, dP, *geo)
            pargs = (P, Rw, Rh, dout, lse, delta, *geo)
            drc = hil_attention_bwd_dq(*args)
            leaves = [P.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()]
            lib_out = library_fwd(*leaves)
            pairs = tok * hw
            ins = (P.numel() + dout.numel()) * es + 2 * tok * 4 + rel_bytes
            row["dkdv"] = {
                "ms": device_ms(lambda: hil_attention_bwd_dkdv(*args), **slow),
                "plain_ms": device_ms(lambda: hil_attention_bwd_dkdv_plain(*pargs), **slow),
                # writes the k, v and pad lanes of dP; per pair S 2*dkh+2, exp 2, dp and dv
                # 4*dvh, ds 2, dk 2*dkh; the RC rows 2*dkh per entry
                **bound(ins + P.numel() * es * (slot - DKH) / slot,
                        pairs * (4 * DKH + 4 * dvh + 6) + tok * (W + H) * 2 * DKH, dtype)}
            row["dq"] = {
                "ms": device_ms(lambda: hil_attention_bwd_dq(*args), **slow),
                "plain_ms": device_ms(lambda: hil_attention_bwd_dq_plain(*pargs), **slow),
                # writes the q lanes of dP and the f32 dRC rows; per pair S 2*dkh+2, exp 2,
                # dp 2*dvh, ds 2, dq 2*dkh, the two bins 2; RC and dq's relative part
                **bound(ins + P.numel() * es * DKH / slot + tok * (W + H) * 4,
                        pairs * (4 * DKH + 2 * dvh + 8) + tok * (W + H) * 4 * DKH, dtype)}
            row["drel"] = {
                "ms": device_ms(lambda: hil_attention_bwd_drel(P, drc, H, W, DKH, slot)),
                "plain_ms": device_ms(
                    lambda: hil_attention_bwd_drel_plain(P, drc, H, W, DKH, slot), **slow),
                # reads the q lanes and the dRC rows, writes dRw and dRh
                **bound(P.numel() * es * DKH / slot + tok * (W + H) * 4 + rel_bytes,
                        tok * (W + H) * 2 * DKH, dtype)}
            row["bwd16"] = {
                "abs_err": errs, "rel_err": rel, "pads_zero": pads_zero, "finite": finite,
                "ms": row["dkdv"]["ms"] + row["dq"]["ms"] + row["drel"]["ms"],
                "host_ms": time_ms(lambda: hil_attention_bwd(P, Rw, Rh, out, lse, dout, *geo),
                                   reps=5, inner=3),
                "library_ms": time_ms(
                    lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True),
                    reps=5, inner=3),
                # the whole backward as one function of (P, Rw, Rh, out, lse, dout)
                **bound(2 * P.numel() * es + 2 * out.numel() * es + tok * 4 + 2 * rel_bytes,
                        pairs * (6 * DKH + 4 * dvh + 8) + tok * (W + H) * 6 * DKH, dtype)}
            del leaves, lib_out, bias, drc, dP, delta, P, out, lse, dout

            # the head-major kernels at the same geometry and batch, device time
            qr, kk, vv = kernel_inputs(H, W, dvh, dtype, gen, batch=B_TRAIN)
            o1, l1 = rel_attention_fwd(qr, kk, vv, H, W, DKH)
            d1 = torch.randn(o1.shape, generator=gen).to(DEVICE, dtype)
            a1 = (qr, kk, vv, d1, l1, attention_delta(o1, d1), H, W, DKH)
            n4 = B * NH
            q4, k4, v4 = (t[:n4].contiguous() for t in (qr, kk, vv))
            row["bn_layout"] = {
                f"b1_ms_batch{B}": device_ms(lambda: rel_attention_fwd(q4, k4, v4, H, W, DKH)),
                f"b1_ms_batch{B_TRAIN}": device_ms(
                    lambda: rel_attention_fwd(qr, kk, vv, H, W, DKH)),
                "b2_dkdv_ms": device_ms(lambda: rel_attention_bwd_dkdv(*a1), **slow),
                "b2_dq_ms": device_ms(lambda: rel_attention_bwd_dq(*a1), **slow)}
            del qr, kk, vv, o1, l1, d1, a1, q4, k4, v4
            torch.cuda.empty_cache()

            f4, f16, bw, bn_l = row[f"fwd{B}"], row[f"fwd{B_TRAIN}"], row["bwd16"], row["bn_layout"]
            row["ok"] = (all(f["finite"] and max(f["abs_err_out"], f["abs_err_lse"]) <= TOL[dtype]
                             for f in (f4, f16))
                         and finite and pads_zero and max(rel.values()) <= BWD_TOL[dtype])
            rows.append(row)
            print(f"kernel hil_attention {H}x{W} dvh={dvh} slot={slot} {row['dtype']}: B5 err "
                  f"out {f4['abs_err_out']:.3g}/{f16['abs_err_out']:.3g} lse "
                  f"{f4['abs_err_lse']:.3g}/{f16['abs_err_lse']:.3g} (tol {TOL[dtype]}); B6 rel "
                  f"err { {n: float(f'{e:.3g}') for n, e in rel.items()} } (tol "
                  f"{BWD_TOL[dtype]}), pads zero {pads_zero}; device ms: B5 b{B} {f4['ms']:.4f} "
                  f"(plain {f4['plain_ms']:.4f}, library {f4['library_ms']:.4f}, bound "
                  f"{f4['bound_ms']:.5f}, B1 {bn_l[f'b1_ms_batch{B}']:.4f}); B5 b{B_TRAIN} "
                  f"{f16['ms']:.4f} (library {f16['library_ms']:.4f}, B1 "
                  f"{bn_l[f'b1_ms_batch{B_TRAIN}']:.4f}); B6 b{B_TRAIN} dkdv "
                  f"{row['dkdv']['ms']:.4f} (plain {row['dkdv']['plain_ms']:.4f}, B2 "
                  f"{bn_l['b2_dkdv_ms']:.4f}) dq {row['dq']['ms']:.4f} (plain "
                  f"{row['dq']['plain_ms']:.4f}, B2 {bn_l['b2_dq_ms']:.4f}) drel "
                  f"{row['drel']['ms']:.4f} (plain {row['drel']['plain_ms']:.4f}); whole "
                  f"{bw['ms']:.4f} (bound {bw['bound_ms']:.5f}, eager library bwd "
                  f"{bw['library_ms']:.4f}); eager ms B5 b{B} {f4['host_ms']:.4f}, B6 "
                  f"{bw['host_ms']:.4f}", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B5 or B6 disagrees with its plain version: {bad}")
    return rows


def jpegs(n: int, size: int = IMAGE):
    from PIL import Image

    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        h, w = size + 16 * (i % 3), size + 24 * (i % 2)
        smooth = np.cumsum(rng.randn(h, w), axis=1)
        img = np.clip(128 + 40 * smooth / (np.abs(smooth).max() + 1e-6)
                      + 20 * rng.randn(h, w), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img, "L").save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def calibrate_bn(model, images, image: int) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    the request images (preprocessed as cli.serve does), on the card. A
    seeded random EfficientNet with its initial statistics (0, 1) saturates
    every served probability at 0 or 1 (32 blocks of BN eps 1e-3 and swish
    grow the activations), which would make the route comparison vacuous."""
    from PIL import Image

    from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD
    from chexpert_tpu_torch.data.transforms import center_crop

    batch = [(center_crop(np.asarray(Image.open(io.BytesIO(data)).convert("L"),
                                     np.float32)[..., None], image) / 255.0 - PIXEL_MEAN)
             / PIXEL_STD for data in images]
    x = torch.from_numpy(np.stack(batch).astype(np.float32)).to(DEVICE).expand(-1, -1, -1, 3)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one forward sets the batch statistics
    with torch.no_grad():
        model.train()(x.permute(0, 3, 1, 2).contiguous(),
                      generator=torch.Generator(device=DEVICE).manual_seed(0))
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    model.eval()


def damp_residuals(model, gamma: float) -> None:
    """Set the scale of the last BatchNorm of every residual block to
    ``gamma``, as a trained ResNet has it (each branch adds a fraction of its
    skip; ``zero_init_residual`` is the same idea at 0). With the seeded
    scale of 1 the 50 blocks of a ResNet-152 amplify f32 rounding so far that
    two f32 routes over the same weights differ by 1.1e-3 to 1.4e-3 of the
    largest logit (scripts/route_noise_torch.py, 320x320, on an NVIDIA H100
    80GB HBM3 at 700 W), which no kernel can change; at 0.25 they differ by
    7e-6 to 8e-6 while zeroing the attention branches still moves the logits
    by 12 times their size, so the route comparison stays tight and means
    something."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "last_bn"):
                m.last_bn.weight.fill_(gamma)


def post(url: str, data: bytes) -> dict:
    req = urllib.request.Request(url + "/predict", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["probabilities"]


def slice_phase(ckpt: str, images, model: str, image: int, per_forward: dict):
    """Serve ``model`` over HTTP from ``ckpt``; every forward must launch
    exactly ``per_forward`` (kernel name -> launches) and no other kernel."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.serve import build_parser, serve

    args = build_parser().parse_args([
        "--restore_path", ckpt, "--model", model, "--image_size", str(image),
        "--device", DEVICE,
        "--compute_dtype", "bfloat16", "--port", "0", "--micro_batch", str(B)])
    kernels.reset_launch_counts()
    httpd = serve(args)  # includes the engine's warm-up forward
    forwards = 1
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    probs, latencies, per_request = [], [], []
    try:
        for data in images + images[:2]:  # the last two repeat the first two
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            probs.append(post(url, data))
            latencies.append((time.perf_counter() - t0) * 1e3)
            forwards += 1
            after = kernels.launch_counts()
            per_request.append({k: after[k] - before.get(k, 0) for k in after
                                if after[k] != before.get(k, 0)})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    counts = kernels.launch_counts()
    vals = np.array([[p[k] for k in p] for p in probs])
    checks = {
        "finite_in_unit_interval": bool(np.isfinite(vals).all() and (vals >= 0).all()
                                        and (vals <= 1).all()),
        "repeat_exact": probs[-2:] == probs[:2],
        "launches_per_request": per_request == [per_forward] * len(per_request),
        # the named kernels per forward and no launch of any other kernel
        # (the backward kernels included)
        "launches_per_forward": counts == {k: v * forwards for k, v in per_forward.items()},
    }
    print(f"slice served {model} bf16 micro_batch {B} layout "
          f"{os.environ.get(LAYOUT_ENV, 'bn')}: {len(probs)} requests, "
          f"{forwards} forwards, launches {counts}, checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: {checks}")
    return probs[:len(images)], latencies, counts, forwards


def reference_phase(ckpt: str, images, served, model: str, image: int, route: dict,
                    per_forward: dict):
    """f32 on the card: the serve entry's kernel route vs the plain route that
    ``route`` names (attn_impl="einsum" / dw_impl="library"). The kernel
    route's two forwards per image must launch ``per_forward`` each, the
    plain route nothing."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.checkpoint import load_model_checkpoint
    from chexpert_tpu_torch.cli.serve import Engine, build_parser
    from chexpert_tpu_torch.models import build_model

    engine = Engine(build_parser().parse_args([
        "--restore_path", ckpt, "--model", model, "--image_size", str(image),
        "--device", DEVICE,
        "--compute_dtype", "float32", "--micro_batch", str(B)]))
    ref = build_model(model, image_size=image, **route)
    ref.load_state_dict(load_model_checkpoint(ckpt)["state_dict"], strict=True)
    ref = ref.to(DEVICE).eval()
    d_f32, d_bf16, d_logit, p_range = 0.0, 0.0, 0.0, (1.0, 0.0)
    kernels.reset_launch_counts()
    for data, p_served in zip(images, served):
        p_kernel = engine.predict(data)
        batch = np.zeros((B, image, image, 3), np.float32)
        batch[0] = engine.preprocess(data)
        x = torch.from_numpy(batch).to(DEVICE).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            logits_ref = ref(x).float()[0]
            logits_kernel = engine.model(x).float()[0]
            p_ref = torch.sigmoid(logits_ref).cpu().numpy()
        kern = np.array([p_kernel[k] for k in p_kernel])
        d_f32 = max(d_f32, float(np.abs(kern - p_ref).max()))
        d_bf16 = max(d_bf16, float(np.abs(np.array([p_served[k] for k in p_served])
                                          - p_ref).max()))
        # the logits too: a probability near 0 or 1 hides a difference
        d_logit = max(d_logit, ((logits_kernel - logits_ref).abs().max()
                                / logits_ref.abs().max()).item())
        p_range = (min(p_range[0], float(p_ref.min())), max(p_range[1], float(p_ref.max())))
    counts = kernels.launch_counts()
    launched = counts == {k: v * 2 * len(images) for k, v in per_forward.items()}
    print(f"reference {model} f32 kernel route vs f32 {route}: max |dp| {d_f32:.3g} "
          f"(tol {EINSUM_TOL}), logits max |d| / max |logit| {d_logit:.3g} (tol {LOGIT_TOL}), "
          f"probabilities "
          f"in [{p_range[0]:.4g}, {p_range[1]:.4g}]; kernel route launches {counts}; served "
          f"bf16 vs that f32 route: max |dp| {d_bf16:.3g} (reported, not gated)", flush=True)
    if not (d_f32 <= EINSUM_TOL and d_logit <= LOGIT_TOL and launched):
        raise AssertionError(f"{model}: kernel route disagrees with {route}: |dp| {d_f32}, "
                             f"logits {d_logit}, or launched {counts}")
    return d_f32, d_bf16, d_logit


def _scalars(run_dir: str, tag: str):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [(r["step"], r["value"]) for r in map(json.loads, f) if r.get("tag") == tag]


def train_phase(data_dir: str, smi: str, model: str, image: int, lr: float,
                per_step: dict, per_eval: dict, steps: int = TRAIN_STEPS, run: str = "run"):
    """The port's training CLI on the card; launch counts read just after:
    ``per_step`` launches per train step and ``per_eval`` per eval forward,
    and no launch of any other kernel."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.chexpert import main as cli_main

    run_dir = os.path.join(data_dir, run)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["--train", "--evaluate_single_model", "--data_path", data_dir,
              "--output_dir", run_dir, "--model", model,
              "--image_size", str(image), "--compute_dtype", "bfloat16",
              "--batch_size", str(B_TRAIN), "--n_epochs", str(steps),
              "--lr", str(lr), "--log_interval", "1",
              "--eval_interval", str(EVAL_INTERVAL), "--device", DEVICE])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [v for _, v in _scalars(run_dir, "train_loss")]
    ips = [v for _, v in _scalars(run_dir, "images_per_sec")]
    # one eval batch per evaluation: after each epoch, at each eval_interval, and the final one
    evals = steps + steps // EVAL_INTERVAL + 1
    want = {k: per_step.get(k, 0) * steps + per_eval.get(k, 0) * evals
            for k in {**per_step, **per_eval}}
    artifacts = ["checkpoint_latest.pt", "optim_checkpoint_latest.pt", "checkpoints_tracker.csv",
                 f"eval_results_step_{steps}.json", "config.json",
                 os.path.join("best_checkpoints", "checkpoint_0.pt")]
    checks = {
        "steps_logged": len(losses) == steps,
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "launches_per_step_and_forward": counts == want,
        "artifacts": all(os.path.exists(os.path.join(run_dir, a)) for a in artifacts),
    }
    steady = ips[1:]  # the first step includes kernel library loads and cuDNN planning
    ips_med = statistics.median(steady)
    ms_step = B_TRAIN / ips_med * 1e3
    print(f"train {model} {image}x{image} bf16 batch {B_TRAIN} lr {lr} layout "
          f"{os.environ.get(LAYOUT_ENV, 'bn')}: "
          f"losses {[round(x, 4) for x in losses]}; launches {counts} (want {want}); "
          f"median over steps 2..{steps}: {ms_step:.2f} ms/step, {ips_med:.2f} img/s "
          f"(all steps img/s {[round(x, 2) for x in ips]}); wall {wall_s:.1f} s "
          f"for {steps} steps + {evals} evals on {smi}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return {"model": model, "losses": losses, "images_per_sec": ips, "ms_per_step": ms_step,
            "images_per_sec_median": ips_med, "counts": counts, "evals": evals,
            "steps": steps, "wall_s": wall_s}


def _max_ratio(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| per tensor."""
    return {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)).item()
            for n in ref}


def grad_reference_phase(data_dir: str, model_name: str = "aadensenet121",
                         layout: str = "bn", n_aa: int = 3, lr: float = 0.01):
    """f32, TF32 off, deterministic cuDNN: one train step's gradients of
    ``model_name`` on the kernel route of ``layout`` and on the einsum route.

    Gated at GRAD_TOL, per AA conv (all ``n_aa`` of them): the layer's real
    input and upstream gradient, captured in the einsum route's train step,
    go through the module on both routes; every gradient (input,
    in_proj_qkv in checkpoint order, key_rel_h, key_rel_w, out_proj, conv)
    must agree. The whole model's gradients are reported, not gated: at
    random init with train-mode BatchNorm they move by ~1e-2 relative under
    a one-ulp change of the input on one route alone
    (scripts/grad_divergence_torch.py shows where), so no bound near
    GRAD_TOL can hold there."""
    import copy

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.data import Batches, ChexpertIndex
    from chexpert_tpu_torch.models import AAConv2d, build_model, optimizer_spec
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME
    from chexpert_tpu_torch.ops.hil_attention import BWD_PASSES, FWD
    from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step

    per_layer = ({NAME: 1, BWD_DKDV: 1, BWD_DQ: 1} if layout == "bn"
                 else {FWD: 1, **{p: 1 for p in BWD_PASSES}})
    torch.backends.cudnn.deterministic = True
    host = next(iter(Batches(ChexpertIndex(data_dir, "train"), 4, image_size=IMAGE)))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    sd = build_model(model_name, image_size=IMAGE,
                     generator=torch.Generator().manual_seed(0)).state_dict()

    def step(route, capture=None):
        model = build_model(model_name, image_size=IMAGE, attn_impl=route, attn_layout=layout)
        model.load_state_dict(sd, strict=True)
        model = model.to(DEVICE)
        handles = []
        for name, mod in model.named_modules():
            if capture is not None and isinstance(mod, AAConv2d):
                def hook(m, inputs, out, name=name):
                    rec = {"module": m, "name": name, "x": inputs[0].detach().clone()}
                    out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
                    capture.append(rec)
                handles.append(mod.register_forward_hook(hook))
        opt, sched, _ = make_optimizer(optimizer_spec(model_name), model.parameters(), lr)
        kernels.reset_launch_counts()
        train_step(TrainState(model, opt, sched), batch, torch.float32)
        torch.cuda.synchronize()
        for h in handles:
            h.remove()
        return ({n: p.grad.detach().clone() for n, p in model.named_parameters()},
                kernels.launch_counts())

    captured = []
    g_kernel, c_kernel = step("pallas")
    g_einsum, c_einsum = step("einsum", capture=captured)
    whole = _max_ratio(g_kernel, g_einsum)

    module, module_counts = {}, []
    for rec in captured:
        res = {}
        for route in ("einsum", "pallas"):
            mod = copy.deepcopy(rec["module"])
            mod.attn_impl = route
            x = rec["x"].clone().requires_grad_()
            kernels.reset_launch_counts()
            mod(x).backward(rec["g"])
            torch.cuda.synchronize()
            if route == "pallas":
                module_counts.append(kernels.launch_counts())
            res[route] = {"x": x.grad, **{n: p.grad for n, p in mod.named_parameters()}}
        for n, r in _max_ratio(res["pallas"], res["einsum"]).items():
            module[f"{rec['name']}.{n}"] = r
    aa_names = [n for n in module if "key_rel" in n or "in_proj_qkv" in n]
    med = statistics.median
    checks = {
        "kernel_route_launches": c_kernel == {k: n_aa for k in per_layer},
        "einsum_route_no_launch": c_einsum == {},
        "layers_captured": len(captured) == n_aa,
        "module_launches": module_counts == [per_layer] * n_aa,
        "aa_params_covered": len(aa_names) == 3 * n_aa,  # key_rel_h, key_rel_w, in_proj_qkv
        "modules_within_tol": max(module.values()) <= GRAD_TOL,
    }
    worst_m = max(module, key=module.get)
    worst_w = max(whole, key=whole.get)
    aa_worst = {leaf: max(module[n] for n in aa_names if n.endswith(leaf))
                for leaf in ("key_rel_h", "key_rel_w", "in_proj_qkv.weight")}
    print(f"grad reference {model_name} layout {layout} f32 batch 4 {IMAGE}x{IMAGE}: per AA conv "
          f"({len(captured)} layers, captured input and upstream grad) worst max|dg|/max|g| "
          f"{module[worst_m]:.3g} ({worst_m}), median {med(module.values()):.3g}, tol "
          f"{GRAD_TOL}; worst over layers of the AA params "
          f"{ {n: float(f'{r:.3g}') for n, r in aa_worst.items()} }; "
          f"whole model ({len(whole)} tensors) kernel vs einsum median {med(whole.values()):.3g} "
          f"max {whole[worst_w]:.3g} ({worst_w}) (reported, not gated); launches step "
          f"{c_kernel}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"grad reference checks failed: {checks}")
    return {"module_worst": module[worst_m], "module_worst_tensor": worst_m,
            "module_median": med(module.values()), "module_aa_worst": aa_worst,
            "whole_median": med(whole.values()), "whole_max": whole[worst_w]}


def dw_grad_reference_phase(data_dir: str):
    """f32, TF32 off, deterministic cuDNN: one efficientnet-b4 train step's
    gradients on the kernel route (B3 / B4) and on the library route, from the
    same weights, batch and generator seed (so the same DropConnect and
    Dropout masks). Gated at GRAD_TOL per stride-1 depthwise layer: the
    layer's real input and upstream gradient, captured in the library
    route's step, go through the layer on both routes; dx and dw must agree.
    The whole model's gradients are reported, not gated (as in
    grad_reference_phase: two f32 routes that round differently move a
    deep net's gradients by more than their own difference)."""
    import copy

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.data import Batches, ChexpertIndex
    from chexpert_tpu_torch.models import build_model, optimizer_spec
    from chexpert_tpu_torch.models.efficientnet import DepthwiseConv
    from chexpert_tpu_torch.ops.depthwise import BWD, FWD
    from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step

    torch.backends.cudnn.deterministic = True
    host = next(iter(Batches(ChexpertIndex(data_dir, "train"), 4, image_size=EFF_IMAGE)))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    sd = build_model(EFF, generator=torch.Generator().manual_seed(0)).state_dict()

    def step(route, capture=None):
        model = build_model(EFF, dw_impl=route)
        model.load_state_dict(sd, strict=True)
        model = model.to(DEVICE)
        handles = []
        for mod in model.modules():
            if capture is not None and isinstance(mod, DepthwiseConv) and mod.stride == 1:
                def hook(m, inputs, out):
                    rec = {"module": m, "x": inputs[0].detach().clone()}
                    out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
                    capture.append(rec)
                handles.append(mod.register_forward_hook(hook))
        opt, sched, _ = make_optimizer(optimizer_spec(EFF), model.parameters(), EFF_TRAIN_LR)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        kernels.reset_launch_counts()
        train_step(TrainState(model, opt, sched, generator=gen), batch, torch.float32)
        torch.cuda.synchronize()
        for h in handles:
            h.remove()
        return ({n: p.grad.detach().clone() for n, p in model.named_parameters()},
                kernels.launch_counts())

    captured = []
    g_kernel, c_kernel = step("kernel")
    g_library, c_library = step("library", capture=captured)
    whole = _max_ratio(g_kernel, g_library)

    layer, layer_counts = {}, []
    for i, rec in enumerate(captured):
        res = {}
        for route in ("library", "kernel"):
            mod = copy.deepcopy(rec["module"])
            mod.dw_impl = route
            x = rec["x"].clone().requires_grad_()
            kernels.reset_launch_counts()
            mod(x).backward(rec["g"])
            torch.cuda.synchronize()
            if route == "kernel":
                layer_counts.append(kernels.launch_counts())
            res[route] = {"x": x.grad, "weight": mod.weight.grad}
        for n, r in _max_ratio(res["kernel"], res["library"]).items():
            layer[f"layer{i}.d{n}"] = r
    med = statistics.median
    checks = {
        "kernel_route_launches": c_kernel == {FWD: DW_LAYERS, BWD: DW_LAYERS},
        "library_route_no_launch": c_library == {},
        "layers_captured": len(captured) == DW_LAYERS,
        "layer_launches": layer_counts == [{FWD: 1, BWD: 1}] * DW_LAYERS,
        "layers_within_tol": max(layer.values()) <= GRAD_TOL,
    }
    worst_l = max(layer, key=layer.get)
    worst_w = max(whole, key=whole.get)
    # a BatchNorm bias whose output only reaches train-mode BatchNorms (every
    # project_bn: convs and skips lead only into BN) has an analytic gradient
    # of 0; its computed one is rounding noise on both routes
    scale = {n: g.abs().max().item() for n, g in g_library.items()}
    print(f"depthwise grad reference f32 {EFF} batch 4 {EFF_IMAGE}x{EFF_IMAGE}: per stride-1 "
          f"depthwise layer (captured input and upstream grad) worst max|dg|/max|g| "
          f"{layer[worst_l]:.3g} ({worst_l}), median {med(layer.values()):.3g}, tol {GRAD_TOL}; "
          f"whole model ({len(whole)} tensors) kernel vs library median "
          f"{med(whole.values()):.3g} max {whole[worst_w]:.3g} ({worst_w}, max |g| "
          f"{scale[worst_w]:.3g} against a median max |g| {med(scale.values()):.3g}) "
          f"(reported, not gated); launches step {c_kernel}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"depthwise grad reference checks failed: {checks}")
    return {"layer_worst": layer[worst_l], "layer_worst_tensor": worst_l,
            "layer_median": med(layer.values()),
            "whole_median": med(whole.values()), "whole_max": whole[worst_w],
            "whole_max_tensor": worst_w, "whole_max_tensor_max_abs_grad": scale[worst_w],
            "median_max_abs_grad": med(scale.values())}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if importlib.util.find_spec("chexpert_tpu_torch") is None:
        print("chip_smoke: chexpert_tpu_torch is not importable; run from a checkout "
              "of the repository", file=sys.stderr)
        return 1
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.data import make_synthetic_dataset
    from chexpert_tpu_torch.models import AAConv2d, build_model
    from chexpert_tpu_torch.ops.depthwise import BWD as DW_BWD
    from chexpert_tpu_torch.ops.depthwise import FWD as DW_FWD
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME
    from chexpert_tpu_torch.ops.hil_attention import BWD_DREL as HIL_DREL
    from chexpert_tpu_torch.ops.hil_attention import BWD_DKDV as HIL_DKDV
    from chexpert_tpu_torch.ops.hil_attention import BWD_DQ as HIL_DQ
    from chexpert_tpu_torch.ops.hil_attention import BWD_PASSES as HIL_PASSES
    from chexpert_tpu_torch.ops.hil_attention import FWD as HIL_FWD

    os.environ.pop(LAYOUT_ENV, None)  # each phase names its layout; the default is bn
    # f32 references in full f32 (no TF32 in cuDNN convs or matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    t0 = t_start = time.perf_counter()
    took = kernels.build()
    build_s = time.perf_counter() - t0
    print(f"card: {smi} | torch.cuda: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernel build {build_s:.2f} s "
          f"{took}", flush=True)

    rows = kernel_phase()
    bwd_rows = bwd_kernel_phase()
    dw_rows = dw_kernel_phase()
    hil_rows = hil_kernel_phase()

    def serve_and_reference(name, image, per_forward, route, calibrate=False, layout=None,
                            n_requests=N_REQUESTS, residual_gamma=None):
        images = jpegs(n_requests, image)
        model = build_model(name, image_size=image, generator=torch.Generator().manual_seed(0))
        if residual_gamma is not None:
            damp_residuals(model, residual_gamma)
        if calibrate:
            calibrate_bn(model.to(DEVICE), images, image)
        with tempfile.TemporaryDirectory(dir=ROOT) as d, attn_layout_env(layout):
            ckpt = os.path.join(d, f"{name}_seed0.pt")
            save_model_checkpoint(ckpt, model.state_dict())
            served, latencies, counts, forwards = slice_phase(ckpt, images, name, image,
                                                              per_forward)
            d_f32, d_bf16, d_logit = reference_phase(ckpt, images, served, name, image, route,
                                                     per_forward)
        p50 = statistics.median(latencies)
        print(f"served p50 request latency {p50:.3f} ms over {len(latencies)} requests "
              f"({name} {image}x{image} bf16, micro_batch {B}) on {smi}", flush=True)
        torch.cuda.empty_cache()
        return {"counts": counts, "forwards": forwards, "p50_ms": p50, "latencies_ms": latencies,
                "f32_vs_plain_route_max_abs_dp": d_f32, "f32_vs_plain_route_logit_rel": d_logit,
                "bf16_vs_f32_plain_route_max_abs_dp": d_bf16}

    def train_and_grads(name, image, lr, per_step, per_eval, grads, layout=None, also=None):
        """Train through the CLI under ``layout``, then the gradient reference;
        ``also`` = (layout, per_step, per_eval): a second, short train run on
        the same fixture that gates that layout's launches."""
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            make_synthetic_dataset(d, n_train=B_TRAIN, n_valid=B_TRAIN, image_size=image)
            with attn_layout_env(layout):
                train = train_phase(d, smi, name, image, lr, per_step, per_eval)
            if also is not None:
                with attn_layout_env(also[0]):
                    train["also"] = train_phase(d, smi, name, image, lr, also[1], also[2],
                                                steps=AA_TRAIN_STEPS_BN, run=f"run_{also[0]}")
            train["grad_reference"] = grads(d)
        torch.cuda.empty_cache()
        return train

    serve = serve_and_reference("aadensenet121", IMAGE, {NAME: 3}, {"attn_impl": "einsum"})
    train = train_and_grads("aadensenet121", IMAGE, TRAIN_LR,
                            {NAME: 3, BWD_DKDV: 3, BWD_DQ: 3}, {NAME: 3}, grad_reference_phase)
    eff_serve = serve_and_reference(EFF, EFF_IMAGE, {DW_FWD: DW_LAYERS}, {"dw_impl": "library"},
                                    calibrate=True)
    eff_train = train_and_grads(EFF, EFF_IMAGE, EFF_TRAIN_LR,
                                {DW_FWD: DW_LAYERS, DW_BWD: DW_LAYERS}, {DW_FWD: DW_LAYERS},
                                dw_grad_reference_phase)
    # aaresnet152 at full width and depth (47 AA convs). Served: the residual
    # branches damped (damp_residuals) and the BatchNorm statistics set from the
    # request images (a seeded random ResNet-152 with statistics (0, 1) doubles
    # its activations' variance at every residual block). Trained: as built.
    aa_model = build_model(AA_RES, image_size=IMAGE, device="meta")
    aa_geo = [(*m.input_dims, m.dv // m.nh) for m in aa_model.modules()
              if isinstance(m, AAConv2d)]
    if {g: aa_geo.count(g) for g in set(aa_geo)} != AA_LAYERS or len(aa_geo) != N_AA:
        raise AssertionError(f"{AA_RES} at {IMAGE}: AA convs {aa_geo} are not {AA_LAYERS}")
    del aa_model
    hil_step = {HIL_FWD: N_AA, **{p: N_AA for p in HIL_PASSES}}
    bn_step = {NAME: N_AA, BWD_DKDV: N_AA, BWD_DQ: N_AA}
    aa_serve = {
        layout: serve_and_reference(AA_RES, IMAGE, per_forward, {"attn_impl": "einsum"},
                                    calibrate=True, layout=layout, n_requests=AA_REQUESTS,
                                    residual_gamma=AA_RESIDUAL_GAMMA)
        for layout, per_forward in (("hil", {HIL_FWD: N_AA}), ("bn", {NAME: N_AA}))}
    aa_train = train_and_grads(
        AA_RES, IMAGE, AA_TRAIN_LR, hil_step, {HIL_FWD: N_AA},
        lambda d: grad_reference_phase(d, AA_RES, "hil", N_AA, AA_TRAIN_LR),
        layout="hil", also=("bn", bn_step, {NAME: N_AA}))
    paths = {"serve aadensenet121": serve["counts"], "train aadensenet121": train["counts"],
             f"serve {EFF}": eff_serve["counts"], f"train {EFF}": eff_train["counts"],
             f"serve {AA_RES} hil": aa_serve["hil"]["counts"],
             f"serve {AA_RES} bn": aa_serve["bn"]["counts"],
             f"train {AA_RES} hil": aa_train["counts"],
             f"train {AA_RES} bn": aa_train["also"]["counts"]}

    def launches(name):  # each path's counts, reset just before it and read just after
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]  # the served dtype
    bytes_ms = sum(r["bytes_ms"] for r in main_rows)
    ops_ms = sum(r["ops_ms"] for r in main_rows)
    train_rows = [r for r in bwd_rows if r["dtype"] == "bfloat16"]  # the trained dtype

    def per_step(key, sub=None):  # one train step launches each pass once per geometry
        return sum(r[key][sub] if sub else r[key] for r in train_rows)

    def bwd_entry(name, key, replaces_note):
        b_ms, o_ms = per_step(key, "bytes_ms"), per_step(key, "ops_ms")
        return {
            "name": name, "route": "cuda",
            "source": "chexpert_tpu_torch/csrc/rel_attention_bwd.cu",
            "replaces": "chexpert_tpu/ops/pallas_attention.py:277",
            **launches(name),
            "max_abs_err": max(max(r["abs_err"].values()) for r in train_rows),
            "max_rel_err": max(max(r["rel_err"].values()) for r in train_rows),
            "ms": per_step(f"{key}_ms"), "plain_ms": per_step(f"{key}_plain_ms"),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": per_step("library_ms"),
            "library_is": "backward of F.scaled_dot_product_attention w.r.t. q, k, v and a "
                          "materialized bias: the whole of B2, both passes",
            "per": f"train step (bn {B_TRAIN * NH}, three geometries, bf16)",
            "pass": replaces_note, "card": smi,
        }

    dw_main = [r for r in dw_rows if r["dtype"] == "bfloat16"]  # served and trained dtype

    def per_layers(call, key):  # the 28 layers launch each geometry `layers` times
        return sum(r["layers"] * r[call][key] for r in dw_main)

    def dw_entry(name, call, source, replaces, errs, per, **extra):
        b_ms, o_ms = per_layers(call, "bytes_ms"), per_layers(call, "ops_ms")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **launches(name),
            "max_abs_err": max(r[call][e] for r in dw_main for e in errs[0]),
            "max_rel_err": max(r[call][e] for r in dw_main for e in errs[1]),
            # device time (CUDA graph replay); the eager calls' time beside it
            "ms": per_layers(call, "ms"), "plain_ms": per_layers(call, "plain_ms"),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": per_layers(call, "library_ms"),
            "host_ms": per_layers(call, "host_ms"),
            "library_host_ms": per_layers(call, "library_host_ms"),
            "per": per, **extra, "card": smi,
        }

    hil_main = [r for r in hil_rows if r["dtype"] == "bfloat16"]  # served and trained dtype

    def per_aa(call, key):  # the 47 AA convs launch each geometry `layers` times
        return sum(r["layers"] * r[call][key] for r in hil_main)

    def hil_entry(name, call, source, replaces, max_abs_err, max_rel_err, per, **extra):
        b_ms, o_ms = per_aa(call, "bytes_ms"), per_aa(call, "ops_ms")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **launches(name), "max_abs_err": max_abs_err,
            **({} if max_rel_err is None else {"max_rel_err": max_rel_err}),
            # device time (CUDA graph replay)
            "ms": per_aa(call, "ms"), "plain_ms": per_aa(call, "plain_ms"),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "per": per, **extra, "card": smi,
        }

    def bn_layout_ms(key):  # B1 / B2 over the same 47 layers, device time
        return sum(r["layers"] * r["bn_layout"][key] for r in hil_main)

    hil_bwd_abs = max(max(r["bwd16"]["abs_err"].values()) for r in hil_main)
    hil_bwd_rel = max(max(r["bwd16"]["rel_err"].values()) for r in hil_main)
    hil_bwd_library = {
        "library_ms": per_aa("bwd16", "library_ms"),
        "library_is": "backward of F.scaled_dot_product_attention w.r.t. P0 (through the "
                      "head-split and head-merge copies) and a materialized bias, events "
                      "around eager calls: the whole of B6, all three passes",
        "whole_b6_ms": per_aa("bwd16", "ms"), "whole_b6_host_ms": per_aa("bwd16", "host_ms"),
        "b2_same_layers_ms": bn_layout_ms("b2_dkdv_ms") + bn_layout_ms("b2_dq_ms")}
    hil_per_step = (f"{AA_RES} train step (batch {B_TRAIN}, {N_AA} AA convs: 8 at 40x40, 36 at "
                    "20x20, 3 at 10x10; bf16)")
    hil_bwd_src = "chexpert_tpu_torch/csrc/hil_attention_bwd.cu"
    hil_bwd_replaces = "chexpert_tpu/ops/pallas_attention.py:853"

    record = {"kernels": [{
        "name": NAME,
        "route": "cuda",
        "source": "chexpert_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "chexpert_tpu/ops/pallas_attention.py:178",
        **launches(NAME),
        # bf16, at the served grid (bn 32) and the training grid (bn 128)
        "max_abs_err": max([max(r["max_abs_err_out"], r["max_abs_err_lse"]) for r in main_rows]
                           + [max(r["fwd_abs_err"].values()) for r in train_rows]),
        # one served forward launches each geometry once: times are per forward
        "ms": sum(r["kernel_ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "per": f"served forward (bn {B * NH}, three geometries, bf16)",
        "train_forward_ms": per_step("fwd_ms"),
        "forwards": serve["forwards"],
        "calls": rows,
        "served_p50_ms": serve["p50_ms"],
        "einsum_max_abs_dp_f32": serve["f32_vs_plain_route_max_abs_dp"],
        "served_bf16_vs_einsum_f32_max_abs_dp": serve["bf16_vs_f32_plain_route_max_abs_dp"],
        "card": smi,
    },
        bwd_entry(BWD_DKDV, "dkdv", "pass 1 of B2: dk, dv"),
        bwd_entry(BWD_DQ, "dq", "pass 2 of B2: dqr = [dq ; dRW ; dRH]"),
        dw_entry(DW_FWD, f"fwd{B}", "chexpert_tpu_torch/csrc/depthwise_fwd.cu",
                 "chexpert_tpu/ops/pallas_depthwise.py:130", (["abs_err"], ["rel_err"]),
                 f"served {EFF} forward (batch {B}, {DW_LAYERS} layers, bf16)",
                 library_is="F.conv2d(groups=C), on whichever backend PyTorch picks "
                            "(its native _conv_depthwise2d kernel or cuDNN)",
                 train_forward_ms=per_layers(f"fwd{B_TRAIN}", "ms"),
                 train_forward_library_ms=per_layers(f"fwd{B_TRAIN}", "library_ms")),
        dw_entry(DW_BWD, "bwd16", "chexpert_tpu_torch/csrc/depthwise_bwd.cu",
                 "chexpert_tpu/ops/pallas_depthwise.py:171",
                 (["abs_err_dx", "abs_err_dw"], ["rel_err_dx", "rel_err_dw"]),
                 f"{EFF} train step (batch {B_TRAIN}, {DW_LAYERS} layers, bf16; one fused "
                 "kernel for dx and per-block dw partials, then one torch sum)",
                 library_is="aten.convolution_backward for dx and dw, on PyTorch's "
                            "pick of backend"),
        hil_entry(HIL_FWD, f"fwd{B}", "chexpert_tpu_torch/csrc/hil_attention_fwd.cu",
                  "chexpert_tpu/ops/pallas_attention.py:785",
                  max(max(r[f"fwd{b}"]["abs_err_out"], r[f"fwd{b}"]["abs_err_lse"])
                      for r in hil_main for b in (B, B_TRAIN)), None,
                  f"served {AA_RES} forward (batch {B}, {N_AA} AA convs: 8 at 40x40, 36 at "
                  "20x20, 3 at 10x10; bf16)",
                  library_ms=per_aa(f"fwd{B}", "library_ms"),
                  library_is="F.scaled_dot_product_attention with the relative bias "
                             "materialized beforehand, plus the head-split copies of q, k, v "
                             "from P0 and the head-merge copy of its output",
                  host_ms=per_aa(f"fwd{B}", "host_ms"),
                  b1_same_layers_ms=bn_layout_ms(f"b1_ms_batch{B}"),
                  train_forward_ms=per_aa(f"fwd{B_TRAIN}", "ms"),
                  train_forward_library_ms=per_aa(f"fwd{B_TRAIN}", "library_ms"),
                  train_forward_b1_same_layers_ms=bn_layout_ms(f"b1_ms_batch{B_TRAIN}")),
        hil_entry(HIL_DKDV, "dkdv", hil_bwd_src, hil_bwd_replaces, hil_bwd_abs, hil_bwd_rel,
                  hil_per_step, **{"pass": "pass 1 of B6: the k, v and pad lanes of dP"},
                  **hil_bwd_library),
        hil_entry(HIL_DQ, "dq", hil_bwd_src, hil_bwd_replaces, hil_bwd_abs, hil_bwd_rel,
                  hil_per_step, **{"pass": "pass 2 of B6: the q lanes of dP and the dRC rows"},
                  **hil_bwd_library),
        hil_entry(HIL_DREL, "drel", hil_bwd_src, hil_bwd_replaces, hil_bwd_abs, hil_bwd_rel,
                  hil_per_step, **{"pass": "pass 3 of B6: dRw, dRh from q and the dRC rows"},
                  **hil_bwd_library),
    ], "b2_whole": {
        "bound_ms": max(per_step("b2", "bytes_ms"), per_step("b2", "ops_ms")),
        "bound_by": ("bytes" if per_step("b2", "bytes_ms") >= per_step("b2", "ops_ms")
                     else "operations"),
        "ms": per_step("dkdv_ms") + per_step("dq_ms"), "calls": bwd_rows},
        "depthwise_calls": dw_rows,
        "serve": serve, "train": {**train, "card": smi},
        f"serve {EFF}": eff_serve, f"train {EFF}": {**eff_train, "card": smi},
        "b6_whole": {"bound_ms": max(per_aa("bwd16", "bytes_ms"), per_aa("bwd16", "ops_ms")),
                     "bound_by": ("bytes" if per_aa("bwd16", "bytes_ms")
                                  >= per_aa("bwd16", "ops_ms") else "operations"),
                     "ms": per_aa("bwd16", "ms")},
        "hil_calls": hil_rows,
        f"serve {AA_RES}": aa_serve, f"train {AA_RES}": {**aa_train, "card": smi}}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
