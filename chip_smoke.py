#!/usr/bin/env python3
"""Smoke run of the PyTorch port (chexpert_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each failing the run on error:

1. build: compiles chexpert_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per source, and prints the card (nvidia-smi name, power limit).
2. kernel: the relative-position attention forward kernel at the three
   aadensenet121 320x320 transition geometries, batch 4 (bn = 32), against
   its plain PyTorch version on the card in f32 and bf16; times the kernel,
   the plain version and one library call of the same function
   (scaled_dot_product_attention with the relative bias materialized).
3. slice: aadensenet121 at 320x320 with seeded random weights, saved by the
   port's checkpoint store and served by chexpert_tpu_torch.cli.serve on the
   card in bf16; JPEG requests over HTTP; launch counts must show every
   forward went through the kernel (3 launches per forward); the f32 kernel
   path must agree with the f32 einsum path within 1e-3.

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
B, NH, DKH = 4, 8, 20                      # micro-batch, heads, head width
GEOMETRIES = ((40, 40, 1), (20, 20, 3), (10, 10, 6))  # (H, W, dvh) at 320x320
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor bf16; f32 non-tensor
# f32: the same f32 algorithm on both sides; online-softmax rescaling and the
# summation order differ, worth ~1e-6 relative on lse ~ 10: 1e-4 leaves margin.
# bf16: both read the same bf16 operands and accumulate in f32; the output is
# rounded to bf16, one ulp of which is 1.6e-2 just below 4: 2e-2 covers one
# rounding flip of |out| < 4 (out is a convex mix of N(0,1) values).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
EINSUM_TOL = 1e-3                          # f32 kernel path vs f32 einsum path
N_REQUESTS = 8


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


def kernel_inputs(H, W, dvh, dtype, gen):
    from chexpert_tpu_torch.ops.attention import pack_query

    hw, bn = H * W, B * NH
    q = torch.randn(B, NH, hw, DKH, generator=gen) * DKH ** -0.5
    k = torch.randn(bn, hw, DKH, generator=gen)
    v = torch.randn(bn, hw, dvh, generator=gen)
    rel_w = torch.randn(DKH, 2 * W - 1, generator=gen) + DKH ** -0.5
    rel_h = torch.randn(DKH, 2 * H - 1, generator=gen) + DKH ** -0.5
    qr = pack_query(q, rel_w, rel_h, H, W).reshape(bn, hw, DKH + W + H)
    return [t.to("cuda", dtype).contiguous() for t in (qr, k, v)]


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
                "bytes": nbytes, "flops": flops,
                "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "ops_ms": flops / PEAK_FLOPS[dtype] * 1e3,
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


def jpegs(n: int):
    from PIL import Image

    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        h, w = 320 + 16 * (i % 3), 320 + 24 * (i % 2)
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
    from chexpert_tpu_torch.ops.fused_attention import NAME

    args = build_parser().parse_args([
        "--restore_path", ckpt, "--model", "aadensenet121", "--image_size", "320",
        "--device", "cuda",
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
    launches = kernels.launch_counts().get(NAME, 0)
    vals = np.array([[p[k] for k in p] for p in probs])
    checks = {
        "finite_in_unit_interval": bool(np.isfinite(vals).all() and (vals >= 0).all()
                                        and (vals <= 1).all()),
        "repeat_exact": probs[-2:] == probs[:2],
        "three_launches_per_request": per_request == [3] * len(per_request),
        "three_launches_per_forward": launches == 3 * forwards,
    }
    print(f"slice served aadensenet121 bf16 micro_batch {B}: {len(probs)} requests, "
          f"{forwards} forwards, {launches} kernel launches, checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: {checks}")
    return probs[:len(images)], latencies, launches, forwards


def reference_phase(ckpt: str, images, served):
    """f32 on the card: the serve entry's kernel path vs the einsum path."""
    from chexpert_tpu_torch.checkpoint import load_model_checkpoint
    from chexpert_tpu_torch.cli.serve import Engine, build_parser
    from chexpert_tpu_torch.models import build_model

    engine = Engine(build_parser().parse_args([
        "--restore_path", ckpt, "--model", "aadensenet121", "--image_size", "320",
        "--device", "cuda",
        "--compute_dtype", "float32", "--micro_batch", str(B)]))
    einsum = build_model("aadensenet121", image_size=320, attn_impl="einsum")
    einsum.load_state_dict(load_model_checkpoint(ckpt)["state_dict"], strict=True)
    einsum = einsum.to("cuda").eval()
    d_f32, d_bf16 = 0.0, 0.0
    for data, p_served in zip(images, served):
        p_kernel = engine.predict(data)
        batch = np.zeros((B, 320, 320, 3), np.float32)
        batch[0] = engine.preprocess(data)
        x = torch.from_numpy(batch).to("cuda").permute(0, 3, 1, 2).contiguous()
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
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.ops.fused_attention import NAME

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

    images = jpegs(N_REQUESTS)
    model = build_model("aadensenet121", image_size=320,
                        generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        ckpt = os.path.join(d, "aadensenet121_seed0.pt")
        save_model_checkpoint(ckpt, model.state_dict())
        served, latencies, launches, forwards = slice_phase(ckpt, images)
        d_f32, d_bf16 = reference_phase(ckpt, images, served)
    p50 = statistics.median(latencies)
    print(f"served p50 request latency {p50:.3f} ms over {len(latencies)} requests "
          f"(aadensenet121 320x320 bf16, micro_batch {B}) on {smi}", flush=True)

    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]  # the served dtype
    bytes_ms = sum(r["bytes_ms"] for r in main_rows)
    ops_ms = sum(r["ops_ms"] for r in main_rows)
    record = {"kernels": [{
        "name": NAME,
        "route": "cuda",
        "source": "chexpert_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "chexpert_tpu/ops/pallas_attention.py:178",
        "launches": launches,
        "max_abs_err": max(max(r["max_abs_err_out"], r["max_abs_err_lse"]) for r in main_rows),
        # one served forward launches each geometry once: times are per forward
        "ms": sum(r["kernel_ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "forwards": forwards,
        "calls": rows,
        "served_p50_ms": p50,
        "einsum_max_abs_dp_f32": d_f32,
        "served_bf16_vs_einsum_f32_max_abs_dp": d_bf16,
        "card": smi,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
