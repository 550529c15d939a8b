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
   the f32 kernel path must agree with the f32 einsum path within 1e-3.
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

The last lines are one {"kernels": [...]} JSON line, the nvidia-smi line,
and {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA device is available or the port is not importable.
"""

from __future__ import annotations

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
EINSUM_TOL = 1e-3                          # f32 kernel path vs f32 einsum path
GRAD_TOL = 1e-3                            # f32 grads, kernel route vs einsum route
N_REQUESTS = 8
TRAIN_STEPS, TRAIN_LR, EVAL_INTERVAL = 6, 0.01, 3


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


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


def jpegs(n: int):
    from PIL import Image

    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        h, w = IMAGE + 16 * (i % 3), IMAGE + 24 * (i % 2)
        smooth = np.cumsum(rng.randn(h, w), axis=1)
        img = np.clip(128 + 40 * smooth / (np.abs(smooth).max() + 1e-6)
                      + 20 * rng.randn(h, w), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img, "L").save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def post(url: str, data: bytes) -> dict:
    req = urllib.request.Request(url + "/predict", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["probabilities"]


def slice_phase(ckpt: str, images):
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.serve import build_parser, serve
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME

    args = build_parser().parse_args([
        "--restore_path", ckpt, "--model", "aadensenet121", "--image_size", str(IMAGE),
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
            before = kernels.launch_counts().get(NAME, 0)
            t0 = time.perf_counter()
            probs.append(post(url, data))
            latencies.append((time.perf_counter() - t0) * 1e3)
            forwards += 1
            per_request.append(kernels.launch_counts().get(NAME, 0) - before)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    counts = kernels.launch_counts()
    launches = counts.get(NAME, 0)
    vals = np.array([[p[k] for k in p] for p in probs])
    checks = {
        "finite_in_unit_interval": bool(np.isfinite(vals).all() and (vals >= 0).all()
                                        and (vals <= 1).all()),
        "repeat_exact": probs[-2:] == probs[:2],
        "three_launches_per_request": per_request == [3] * len(per_request),
        "three_launches_per_forward": launches == 3 * forwards,
        "no_backward_launch": counts.get(BWD_DKDV, 0) == 0 and counts.get(BWD_DQ, 0) == 0,
    }
    print(f"slice served aadensenet121 bf16 micro_batch {B}: {len(probs)} requests, "
          f"{forwards} forwards, launches {counts}, checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: {checks}")
    return probs[:len(images)], latencies, counts, forwards


def reference_phase(ckpt: str, images, served):
    """f32 on the card: the serve entry's kernel path vs the einsum path."""
    from chexpert_tpu_torch.checkpoint import load_model_checkpoint
    from chexpert_tpu_torch.cli.serve import Engine, build_parser
    from chexpert_tpu_torch.models import build_model

    engine = Engine(build_parser().parse_args([
        "--restore_path", ckpt, "--model", "aadensenet121", "--image_size", str(IMAGE),
        "--device", DEVICE,
        "--compute_dtype", "float32", "--micro_batch", str(B)]))
    einsum = build_model("aadensenet121", image_size=IMAGE, attn_impl="einsum")
    einsum.load_state_dict(load_model_checkpoint(ckpt)["state_dict"], strict=True)
    einsum = einsum.to(DEVICE).eval()
    d_f32, d_bf16 = 0.0, 0.0
    for data, p_served in zip(images, served):
        p_kernel = engine.predict(data)
        batch = np.zeros((B, IMAGE, IMAGE, 3), np.float32)
        batch[0] = engine.preprocess(data)
        x = torch.from_numpy(batch).to(DEVICE).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            p_ref = torch.sigmoid(einsum(x).float())[0].cpu().numpy()
        kern = np.array([p_kernel[k] for k in p_kernel])
        d_f32 = max(d_f32, float(np.abs(kern - p_ref).max()))
        d_bf16 = max(d_bf16, float(np.abs(np.array([p_served[k] for k in p_served])
                                          - p_ref).max()))
    print(f"reference f32 kernel path vs f32 einsum path: max |dp| {d_f32:.3g} "
          f"(tol {EINSUM_TOL}); served bf16 vs f32 einsum: max |dp| {d_bf16:.3g} "
          "(reported, not gated)", flush=True)
    if not d_f32 <= EINSUM_TOL:
        raise AssertionError(f"kernel path disagrees with einsum path: {d_f32}")
    return d_f32, d_bf16


def _scalars(run_dir: str, tag: str):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [(r["step"], r["value"]) for r in map(json.loads, f) if r.get("tag") == tag]


def train_phase(data_dir: str, smi: str):
    """The port's training CLI on the card; launch counts read just after."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.chexpert import main as cli_main
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME

    run_dir = os.path.join(data_dir, "run")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["--train", "--evaluate_single_model", "--data_path", data_dir,
              "--output_dir", run_dir, "--model", "aadensenet121",
              "--image_size", str(IMAGE), "--compute_dtype", "bfloat16",
              "--batch_size", str(B_TRAIN), "--n_epochs", str(TRAIN_STEPS),
              "--lr", str(TRAIN_LR), "--log_interval", "1",
              "--eval_interval", str(EVAL_INTERVAL), "--device", DEVICE])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [v for _, v in _scalars(run_dir, "train_loss")]
    ips = [v for _, v in _scalars(run_dir, "images_per_sec")]
    # one eval batch per evaluation: after each epoch, at each eval_interval, and the final one
    evals = TRAIN_STEPS + TRAIN_STEPS // EVAL_INTERVAL + 1
    want = {NAME: 3 * (TRAIN_STEPS + evals), BWD_DKDV: 3 * TRAIN_STEPS, BWD_DQ: 3 * TRAIN_STEPS}
    artifacts = ["checkpoint_latest.pt", "optim_checkpoint_latest.pt", "checkpoints_tracker.csv",
                 f"eval_results_step_{TRAIN_STEPS}.json", "config.json",
                 os.path.join("best_checkpoints", "checkpoint_0.pt")]
    checks = {
        "steps_logged": len(losses) == TRAIN_STEPS,
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "launches_3_per_step_and_forward": {k: counts.get(k, 0) for k in want} == want,
        "artifacts": all(os.path.exists(os.path.join(run_dir, a)) for a in artifacts),
    }
    steady = ips[1:]  # the first step includes kernel library loads and cuDNN planning
    ips_med = statistics.median(steady)
    ms_step = B_TRAIN / ips_med * 1e3
    print(f"train aadensenet121 {IMAGE}x{IMAGE} bf16 batch {B_TRAIN} lr {TRAIN_LR}: "
          f"losses {[round(x, 4) for x in losses]}; launches {counts} (want {want}); "
          f"median over steps 2..{TRAIN_STEPS}: {ms_step:.2f} ms/step, {ips_med:.2f} img/s "
          f"(all steps img/s {[round(x, 2) for x in ips]}); wall {wall_s:.1f} s "
          f"for {TRAIN_STEPS} steps + {evals} evals on {smi}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return {"losses": losses, "images_per_sec": ips, "ms_per_step": ms_step,
            "images_per_sec_median": ips_med, "counts": counts, "evals": evals,
            "wall_s": wall_s}


def _max_ratio(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| per tensor."""
    return {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)).item()
            for n in ref}


def grad_reference_phase(data_dir: str):
    """f32, TF32 off, deterministic cuDNN: one train step's gradients on the
    kernel route and on the einsum route.

    Gated at GRAD_TOL, per AA transition: the transition's real input and
    upstream gradient, captured in the einsum route's train step, go through
    the module on both routes; every gradient (input, in_proj_qkv, key_rel_h,
    key_rel_w, out_proj, conv) must agree. The whole model's gradients are
    reported, not gated: at random init with train-mode BatchNorm they move
    by ~1e-2 relative under a one-ulp change of the input on one route alone
    (scripts/grad_divergence_torch.py shows where), so no bound near
    GRAD_TOL can hold there."""
    import copy

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.data import Batches, ChexpertIndex
    from chexpert_tpu_torch.models import AAConv2d, build_model, optimizer_spec
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME
    from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step

    torch.backends.cudnn.deterministic = True
    host = next(iter(Batches(ChexpertIndex(data_dir, "train"), 4, image_size=IMAGE)))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    sd = build_model("aadensenet121", image_size=IMAGE,
                     generator=torch.Generator().manual_seed(0)).state_dict()

    def step(route, capture=None):
        model = build_model("aadensenet121", image_size=IMAGE, attn_impl=route)
        model.load_state_dict(sd, strict=True)
        model = model.to(DEVICE)
        handles = []
        for mod in model.modules():
            if capture is not None and isinstance(mod, AAConv2d):
                def hook(m, inputs, out):
                    rec = {"module": m, "x": inputs[0].detach().clone()}
                    out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
                    capture.append(rec)
                handles.append(mod.register_forward_hook(hook))
        opt, sched, _ = make_optimizer(optimizer_spec("aadensenet121"), model.parameters(), 0.01)
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
    for i, rec in enumerate(captured):
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
            module[f"transition{i + 1}.{n}"] = r
    aa_names = [n for n in module if "key_rel" in n or "in_proj_qkv" in n]
    med = statistics.median
    checks = {
        "kernel_route_launches": c_kernel == {NAME: 3, BWD_DKDV: 3, BWD_DQ: 3},
        "einsum_route_no_launch": c_einsum == {},
        "module_launches": module_counts == [{NAME: 1, BWD_DKDV: 1, BWD_DQ: 1}] * 3,
        "aa_params_covered": len(aa_names) == 9,  # key_rel_h, key_rel_w, in_proj_qkv x 3
        "modules_within_tol": max(module.values()) <= GRAD_TOL,
    }
    worst_m = max(module, key=module.get)
    worst_w = max(whole, key=whole.get)
    print(f"grad reference f32 batch 4 {IMAGE}x{IMAGE}: per AA transition (captured input and "
          f"upstream grad) worst max|dg|/max|g| {module[worst_m]:.3g} ({worst_m}), tol "
          f"{GRAD_TOL}; AA params { {n: float(f'{module[n]:.3g}') for n in aa_names} }; "
          f"whole model ({len(whole)} tensors) kernel vs einsum median {med(whole.values()):.3g} "
          f"max {whole[worst_w]:.3g} ({worst_w}) (reported, not gated); launches step {c_kernel} modules {module_counts}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"grad reference checks failed: {checks}")
    return {"module_worst": module[worst_m], "module_worst_tensor": worst_m,
            "module_aa": {n: module[n] for n in aa_names},
            "whole_median": med(whole.values()), "whole_max": whole[worst_w]}


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
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME

    # f32 references in full f32 (no TF32 in cuDNN convs or matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    t0 = time.perf_counter()
    took = kernels.build()
    build_s = time.perf_counter() - t0
    print(f"card: {smi} | torch.cuda: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernel build {build_s:.2f} s "
          f"{took}", flush=True)

    rows = kernel_phase()
    bwd_rows = bwd_kernel_phase()

    images = jpegs(N_REQUESTS)
    model = build_model("aadensenet121", image_size=IMAGE,
                        generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        ckpt = os.path.join(d, "aadensenet121_seed0.pt")
        save_model_checkpoint(ckpt, model.state_dict())
        served, latencies, serve_counts, forwards = slice_phase(ckpt, images)
        d_f32, d_bf16 = reference_phase(ckpt, images, served)
    p50 = statistics.median(latencies)
    print(f"served p50 request latency {p50:.3f} ms over {len(latencies)} requests "
          f"(aadensenet121 {IMAGE}x{IMAGE} bf16, micro_batch {B}) on {smi}", flush=True)

    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=B_TRAIN, n_valid=B_TRAIN, image_size=IMAGE)
        train = train_phase(d, smi)
        grad = grad_reference_phase(d)

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
            "launches": serve_counts.get(name, 0) + train["counts"].get(name, 0),
            "launches_by_path": {"serve": serve_counts.get(name, 0),
                                 "train": train["counts"].get(name, 0)},
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

    record = {"kernels": [{
        "name": NAME,
        "route": "cuda",
        "source": "chexpert_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "chexpert_tpu/ops/pallas_attention.py:178",
        "launches": serve_counts.get(NAME, 0) + train["counts"].get(NAME, 0),
        "launches_by_path": {"serve": serve_counts.get(NAME, 0),
                             "train": train["counts"].get(NAME, 0)},
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
        "forwards": forwards,
        "calls": rows,
        "served_p50_ms": p50,
        "einsum_max_abs_dp_f32": d_f32,
        "served_bf16_vs_einsum_f32_max_abs_dp": d_bf16,
        "card": smi,
    },
        bwd_entry(BWD_DKDV, "dkdv", "pass 1 of B2: dk, dv"),
        bwd_entry(BWD_DQ, "dq", "pass 2 of B2: dqr = [dq ; dRW ; dRH]"),
    ], "b2_whole": {
        "bound_ms": max(per_step("b2", "bytes_ms"), per_step("b2", "ops_ms")),
        "bound_by": ("bytes" if per_step("b2", "bytes_ms") >= per_step("b2", "ops_ms")
                     else "operations"),
        "ms": per_step("dkdv_ms") + per_step("dq_ms"), "calls": bwd_rows},
        "train": {**train, "grad_reference": grad, "card": smi}}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
