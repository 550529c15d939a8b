#!/usr/bin/env python3
"""Smoke run of the PyTorch port (chexpert_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each failing the run on error:

1. build: compiles chexpert_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
   process per library of ops.kernel_targets, all started together: each
   attention source once per head-width class of ops/fused_attention.py
   (width_targets: WIDTH_CLASSES, built with -DATTN_KW / -DATTN_VW), the
   depthwise sources once; prints the card
   (nvidia-smi name, power limit, maximum SM clock) and each library's build
   seconds.
2. kernel B1: the relative-position attention forward kernel at the three
   aadensenet121 320x320 transition geometries, batch 4 (bn = 32), against
   its plain PyTorch version on the card in f32 and bf16; device time (CUDA-
   graph replay) of the kernel, the plain version and one library call of
   the same function (scaled_dot_product_attention with the relative bias
   materialized), the eager time beside it. The bf16 kernels of B1, B2, B5
   and B6 are the tensor-core kernels, the f32 ones the CUDA-core kernels.
   Then B1 and B5 in bf16 on two ragged maps, 33x17 (the tensor-core
   kernels) and 72x64 (past the tensor-core rule: the CUDA-core kernels),
   against their plain versions.
3. kernel B2: B1 and the backward kernel's two passes (dk/dv, then dq with
   the dRW/dRH bins) at the same geometries with bn = 128 (the training
   batch 16 x 8 heads), in f32 and bf16, against their plain versions; device
   time (CUDA-graph replay) of each pass beside its eager time, its plain
   version, B1 at bn 128, and the backward of the library call with a bias
   that requires grad (device time: the profiler's sum over the kernels of
   eager calls; events around them beside it).
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
   the wrapper's and the library call's eager time beside it. Then B3 and B4
   in f32 and bf16 on the shapes the tile plan of csrc/depthwise_common.cuh
   treats apart (DW_RAGGED: an odd plane size, 12-wide rows, C = G +- 1 for
   grouped planes, B = 1, H below one band, rows wider than one tile, k = 7
   and 9, operands that start off a 16-byte boundary) against their plain
   versions, at the same tolerances.
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
   and head-merge copies from and to the packed layout included; its backward
   by device time as in phase 3) and B1 / B2 at the same geometry and batch,
   B1 beside its own library call (SDPA with the bias materialized) and its
   bound.
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
15. ensemble: three seeded aadensenet121 members at 320x320 saved by the
   checkpoint store into a directory, then cli.chexpert.main
   --evaluate_ensemble --restore DIR on a 320x320 synthetic valid set (two
   views per study, two batches of 16), bf16, once unchunked and once with
   --ensemble_member_chunk 1: exactly members x 3 B1 launches per valid
   batch (plus the 3 of the planner's one measuring forward when unchunked)
   and no other kernel, eval_results_ensemble.json written, the two runs'
   metrics equal; on the same members and batches the ensemble's mean logits
   equal the mean of three single-model evaluate passes, and chunk 1 equals
   unchunked, within 1e-5 of the largest logit in f32 (bf16 reported);
   prints the planned chunk, ms per member per batch, and one member's
   forward on a resident batch with its device time.
16. predict: python -m chexpert_tpu_torch.cli.predict's main on a test csv
   of that valid set's images (absolute paths), for each checkpoint and for
   the directory: header Study + the 5 labels, one row per study (sorted),
   values in [0, 1], 3 B1 launches per forward per checkpoint, and the
   directory's csv the mean of the checkpoints' csvs within 1e-6.
17. Grad-CAM and attention capture through cli.chexpert's
   collect_visualization on the vis subset of an 8-image valid set, bf16,
   micro-batch 4: aadensenet121 (layout bn), aaresnet152 under hil (BatchNorm
   statistics set from the vis images, residual branches damped, as phase
   12) and efficientnet-b4 at 380x380 (statistics from the vis images).
   Launches exactly the forward kernels per vis batch (3 B1 / 47 B5 / 28
   B3) and none else: no backward kernel (B2, B6, B4), and the capture
   (einsum route) none; every CAM finite, in [0, 1], of shape (N, 1, H, W);
   captured softmax rows sum to 1 within 1e-3; the f32 kernel route's CAM
   within 1e-3 of the f32 einsum / library route's on the first vis batch;
   prints ms per vis batch, and its device time. No PNG is rendered on the
   card.
18. multi-process training (chexpert_tpu_torch.parallel): (a) phase 5's run
   (fixture, lr, bf16, batch 16), 3 steps, through cli.chexpert.main
   --multihost with torchrun's variables for world 1 (RANK=0 WORLD_SIZE=1
   LOCAL_RANK=0, a free MASTER_PORT): one NCCL process group of world 1, the
   launches of phase 5 per step and eval forward, the artifacts; prints its
   ms/step beside phase 5's. (b) world 2 on the one card under gloo (NCCL
   refuses two ranks on one device): this script re-run twice as ranks
   (WORKER_FLAG), each calling cli.chexpert.main --multihost in its own
   process, f32, TF32 off, aadensenet121 320x320, global batch 8, 3 steps
   at lr 1e-4, eval and checkpoint after each step, against world 1 of the
   same run in this process and beside world 1 with its first input moved
   one ulp (the noise floor of f32 rounding): the first step's loss within
   1e-6 of the largest loss; every step's loss within 1e-4 of it, and the
   parameters and BatchNorm statistics after each step (per tensor max |d| /
   max |change|, median over tensors) within 1e-3, or within 2x the noise
   floor where rounding alone moves world 1 past those bounds; each rank 3
   B1 + 3 of each B2 pass per step and 3 B1 per eval forward, all at bn 32;
   the loss rank 0 logs the mean of the ranks' local losses; the global
   BatchNorm run on CUDA tensors in training; the artifacts of world 1,
   written once. A gloo collective that refuses CUDA tensors fails the
   rank, and the phase with it.
19. the CIFAR bench (chexpert_tpu_torch.cli.bench, --synthetic, bf16, batch
   256, 32x32): first every kernel at every geometry of the bench's models,
   f32 and bf16 against its plain version within the bounds of phases 2, 3,
   7 and 11 (B1, B2, B5, B6 at WideResNet-28-10's 16x16 dvh 4 and 8x8 dvh 8,
   ResNet-50's 4x4, 2x2 and 1x1 maps and DenseNet-12-100's 16x16 and 8x8
   at dvh 1, all at batch 256 x 8 heads; B3 and B4 at efficientnet-b0's
   twelve stride-1 layers, 16x16 down to 1x1 at k 3 and 5, C up to 1152),
   bf16 device times beside bound, plain version and library call; then
   the four attention kernels and every pass at each head-width class
   (WIDTH_GEOS: (dkh, dvh) = (24, 8), (26, 8), (32, 16), (20, 16), (64, 32)
   at 16x16 and 8x8, (128, 64) at 8x8) and past the largest class, in
   chunks of the head dimensions ((160, 64) at 16x16, (320, 128) and the
   ragged (150, 75) at 8x8, (512, 256) at 1x1), batch 256 x 2 heads, f32 and
   bf16 against the plain versions at the same bounds, both dtypes timed
   beside the bound at the real widths, the plain version and the library
   call; then
   each AA conv and stride-1 depthwise conv of those models alone, f32,
   kernel route against plain route on its captured input and upstream
   gradient within GRAD_TOL (bench_layer_phase); then the runs through
   cli.bench.main: wideresnet 28 10 --attn under bn and under hil, an
   8-step --mini_data overfit with --evaluate and --vis_attn (falling loss;
   per step 8 B1 and 8 of each B2 pass, or 8 B5 and 8 of each B6 pass; 8
   B1 or B5 per eval forward; none on the capture), resnet 50 --attn,
   densenet 12 100 --attn and efficientnet b0 for 4 steps (13, 2 and 12
   layers' launches per step, counted from the models), wideresnet 28 10
   --attn --attn_nh 2 (heads (32, 16) at 16x16 and (64, 32) at 8x8) and
   --attn_k 0.5 --attn_v 0.2 --attn_nh 1 (heads (160, 64) and (320, 128),
   past the largest class) as the first under bn and hil, --attn_k 0.33
   (dkh 26) and --attn_k 1.0 --attn_v 0.5 --attn_nh 1 (heads (320, 160) and
   (640, 320)) for 2 steps under bn, each with its per-layer f32 gate;
   ms/step, device ms per step and busy share (profiler), img/s, peak
   memory.
20. the fast input path on phase 5's model and fixture: cli.chexpert.main
   with --packed_cache, with --packed_cache --data_aug --device_aug (the
   crop in the train step) and with --packed_cache --profile over 8 steps
   (a trace under <output_dir>/profile): phase 5's launches, falling loss;
   the input pipelines alone in ms per batch (JPEG Batches, PackedBatches,
   PackedBatches(emit_stored=True)) beside the three runs' ms/step and
   which JPEG decoder ran (native libjpeg or PIL); then --pretrained from
   a legacy-format densenet121.pth: the step starts from the file's
   weights, the head excepted.

The phases take three to four minutes on an H100, the build included (the run
prints its own time). The last lines are one {"kernels": [...]} JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is available or the port is not importable.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import socket
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
# exp (ex2) runs on the special function units: 16 per SM and clock, 132 SMs
EXPS_PER_CLOCK = 16 * 132
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
MP_TRAIN_STEPS = 3                         # phase 18(a): phase 5 under --multihost, shorter
DDP_BATCH, DDP_STEPS = 8, 3                # phase 18(b): global batch (bn 32 a rank), steps
# lr 1e-4: at 1e-2 and 1e-3 three f32 steps amplify rounding so far that world
# 1 with its first input moved one ulp parts from world 1 by 1e-3..6e-3 of
# the loss and 0.29..0.42 (median) of the parameters' change; at 1e-4 by
# 4.7e-4 and 0.066 (measured on an H100 80GB HBM3 at 700 W: the noise floor below)
DDP_LR = 1e-4
DDP_FIRST_LOSS_TOL = 1e-6                  # the first step's loss (one forward, no update yet)
# world 2 vs world 1, losses of the largest loss and parameters (per-tensor
# max |d| / max |change|, median over tensors) after each step: within
# DDP_LOSS_TOL / GRAD_TOL, or within NOISE_FACTOR x the one-ulp noise floor
# where rounding alone moves world 1 past them (ReLUs whose sign flips,
# ROADMAP C.8: the first step's gradients already part by ~7e-3)
DDP_LOSS_TOL = 1e-4
NOISE_FACTOR = 2.0
DDP_TIMEOUT_S = 600
WORKER_FLAG = "--ddp-worker"               # chip_smoke.py re-run as one rank of phase 18(b)

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
# (B, H, W, C, k, lead): shapes the depthwise tile plan treats apart, the
# operands starting `lead` elements past an allocation's start
DW_RAGGED = ((1, 95, 95, 5, 3, 0), (3, 95, 95, 2, 5, 1), (1, 12, 12, 27, 3, 0),
             (2, 12, 12, 29, 5, 3), (1, 12, 12, 57, 3, 1), (2, 24, 24, 8, 5, 0),
             (1, 3, 190, 4, 3, 0), (2, 2, 301, 3, 5, 1), (2, 40, 40, 6, 7, 0),
             (1, 33, 30, 5, 9, 1), (3, 5, 3, 33, 5, 0), (1, 1, 1, 5, 3, 0))

AA_RES = "aaresnet152"                     # Bottleneck (3, 8, 36, 3), AA convs on layers 2-4
# its AA convs per (H, W, dvh) of GEOMETRIES at 320x320: the blocks of layers 2 / 3 / 4
AA_LAYERS = {(40, 40, 1): 8, (20, 20, 3): 36, (10, 10, 6): 3}
N_AA = 47
AA_TRAIN_LR = 1e-4                         # Adam: a CPU rehearsal at 64x64 fell 3.85 -> 2.45 in 5 steps
AA_REQUESTS = 4
AA_RESIDUAL_GAMMA = 0.25                   # the served model's residual scale: see damp_residuals
AA_TRAIN_STEPS_BN = 3                      # the bn layout's train run only gates its launches
LAYOUT_ENV = "CHEXPERT_ATTN_LAYOUT"        # read once by build_model, as the JAX package names it
# the ensemble / predict fixture: two views per study, two valid batches of the CLI's 16
ENS_MODEL, ENS_MEMBERS, ENS_VALID = "aadensenet121", 3, 2 * B_TRAIN
# the ensemble's mean logits against the mean of its members' single-model
# passes, and chunked against unchunked, max |d| / max |logit|: the same
# deterministic kernels and cuDNN calls on the same inputs, the three logits
# summed in another order on the device or the host (f32, one rounding of a
# sum of three: ~1e-7 relative)
ENS_TOL = 1e-5
PREDICT_TOL = 1e-6                         # directory csv vs the mean of the checkpoints' csvs
VIS_VALID = 8                              # valid images the vis subset is picked from
# the f32 kernel route's CAM vs the f32 einsum / library route's, max |d| on
# maps in [0, 1]: the features at the site differ by f32 rounding (~1e-6
# relative, see LOGIT_TOL), and the CAM divides their weighted sum by its
# range; aaresnet152 amplifies rounding through 50 blocks (damped here as in
# phase 12), so the serve phases' probability gate is taken
CAM_TOL = 1e-3
ROW_SUM_TOL = 1e-3                         # captured softmax rows sum to 1


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's maximum SM clock, which sets its exp rate."""
    return float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


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


def profiled_device_ms(fn, reps: int = 5) -> float:
    """Device time per call of an eager function that cannot be captured in a
    CUDA graph (autograd's engine syncs with the stream its leaves were made
    on, which a capture forbids): the profiler's sum of device time over every
    kernel and copy of reps calls, host gaps between them left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    total_us = sum(getattr(e, attr) for e in avgs
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / 1e3 / reps


def kernel_inputs(H, W, dvh, dtype, gen, batch=B, dkh=DKH, nh=NH):
    from chexpert_tpu_torch.ops.attention import pack_query

    hw, bn = H * W, batch * nh
    q = torch.randn(batch, nh, hw, dkh, generator=gen) * dkh ** -0.5
    k = torch.randn(bn, hw, dkh, generator=gen)
    v = torch.randn(bn, hw, dvh, generator=gen)
    rel_w = torch.randn(dkh, 2 * W - 1, generator=gen) + dkh ** -0.5
    rel_h = torch.randn(dkh, 2 * H - 1, generator=gen) + dkh ** -0.5
    qr = pack_query(q, rel_w, rel_h, H, W).reshape(bn, hw, dkh + W + H)
    return [t.to(DEVICE, dtype).contiguous() for t in (qr, k, v)]


_BOUND_PARTS = {"bytes_ms": "bytes", "ops_ms": "operations", "exp_ms": "exp"}


def _bound_of(parts: dict) -> dict:
    key = max(_BOUND_PARTS, key=lambda k: parts[k])  # ties go to the first: bytes
    return {**parts, "bound_ms": parts[key], "bound_by": _BOUND_PARTS[key]}


def bound(nbytes: float, flops: float, dtype, exps: float = 0.0) -> dict:
    """The least time of a call: the bytes it must move over the memory rate,
    its operations over the peak rate of their type, its exps over the
    special function units' rate at the card's maximum SM clock; the largest
    binds."""
    return {"bytes": nbytes, "flops": flops, "exps": exps, **_bound_of({
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "ops_ms": flops / PEAK_FLOPS[dtype] * 1e3,
        "exp_ms": exps / (EXPS_PER_CLOCK * sm_clock_mhz() * 1e6) * 1e3})}


def bound_sum(terms) -> dict:
    """The bound of several calls, terms = (count, bound of one call): each
    part summed over the calls, the largest sum binding."""
    terms = list(terms)
    return _bound_of({k: sum(n * b[k] for n, b in terms) for k in _BOUND_PARTS})


def b1_bound(bn: int, H: int, W: int, dvh: int, dtype, dkh: int = DKH) -> dict:
    """B1 at bn slices: qr, k, v read and out, lse written once; per (query,
    key) pair q.k 2*dkh, the two relative terms 2, max and sum 2, p.v 2*dvh,
    and one exp. The head widths are the real ones, not a width class's."""
    hw, L = H * W, dkh + W + H
    pairs = bn * hw * hw
    es = torch.finfo(dtype).bits // 8
    return bound(bn * hw * (L + dkh + 2 * dvh) * es + bn * hw * 4,
                 pairs * (2 * dkh + 4 + 2 * dvh), dtype, pairs)


def split_bound(parts: dict, dtype) -> dict:
    """The bounds of a function whose work is split over passes, parts =
    {pass: (bytes, flops, exps)}: each pass's share, and the whole function
    ("whole") from the summed shares."""
    nbytes, flops, exps = (sum(p[i] for p in parts.values()) for i in range(3))
    return {**{k: bound(b, f, dtype, e) for k, (b, f, e) in parts.items()},
            "whole": bound(nbytes, flops, dtype, exps)}


def b2_bounds(bn: int, H: int, W: int, dvh: int, dtype, dkh: int = DKH) -> dict:
    """B2 as one function of (qr, k, v, out, lse, dout): each read once, dqr,
    dk, dv written once; per (query, key) pair S 2 dkh + 2, dp and dv 4 dvh,
    ds 2, dk and dq 4 dkh, the two bins 2, one exp. Split over the passes
    that do the work first: dkdv reads the operands, writes dk, dv and takes
    the exps; dq writes dqr and adds its product. What dq does again (S, p,
    dp) is the two-pass design's cost, not the bound's."""
    hw, L = H * W, dkh + W + H
    pairs, es = bn * hw * hw, torch.finfo(dtype).bits // 8
    ins = bn * hw * (L + dkh + 3 * dvh) * es + bn * hw * 4
    return split_bound({
        "dkdv": (ins + bn * hw * (dkh + dvh) * es, pairs * (4 * dkh + 4 * dvh + 4), pairs),
        "dq": (bn * hw * L * es, pairs * (2 * dkh + 2), 0)}, dtype)


def b5_bound(B: int, nh: int, H: int, W: int, dvh: int, slot: int, dtype,
             dkh: int = DKH) -> dict:
    """B5 over the packed operand: P (slot lanes a head), Rw, Rh read, out and
    lse written once; per pair B1's operations, per query the RC rows 2 dkh
    (W + H); one exp per pair."""
    hw, tok = H * W, B * nh * H * W
    es = torch.finfo(dtype).bits // 8
    rel_bytes = (W * W + H * H) * dkh * 4
    return bound(B * hw * nh * slot * es + rel_bytes + B * hw * nh * dvh * es + tok * 4,
                 tok * hw * (2 * dkh + 4 + 2 * dvh) + tok * (W + H) * 2 * dkh, dtype, tok * hw)


def b6_bounds(B: int, nh: int, H: int, W: int, dvh: int, slot: int, dtype,
              dkh: int = DKH) -> dict:
    """B6 as one function of (P, Rw, Rh, out, lse, dout): each read once, dP
    (every lane), dRw and dRh written once; per pair B2's operations and one
    exp, per query the RC rows, their gradient and dq's relative part 6 dkh
    (W + H). Split over the passes that do the work first: dq reads the
    operands, writes the q lanes of dP, takes the exps and the RC products;
    dkdv writes the k, v and pad lanes and adds dk, dv; drel writes dRw, dRh
    and adds their product. The f32 RC and dRC rows the passes hand on, and
    the S, p and dp that dkdv computes again, are the design's cost, not the
    bound's."""
    hw, tok = H * W, B * nh * H * W
    pairs, es = tok * hw, torch.finfo(dtype).bits // 8
    P_bytes, rel_bytes = B * hw * nh * slot * es, (W * W + H * H) * dkh * 4
    ins = P_bytes + 2 * tok * dvh * es + tok * 4 + rel_bytes  # P, out, dout, lse, Rw, Rh
    return split_bound({
        "dq": (ins + P_bytes * dkh / slot,
               pairs * (4 * dkh + 2 * dvh + 6) + tok * (W + H) * 4 * dkh, pairs),
        "dkdv": (P_bytes * (slot - dkh) / slot, pairs * (2 * dkh + 2 * dvh), 0),
        "drel": (rel_bytes, tok * (W + H) * 2 * dkh, 0)}, dtype)


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
            rows.append({
                "geometry": f"{H}x{W}", "hw": hw, "bn": B * NH, "dkh": DKH, "dvh": dvh,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err_out": err_out, "max_abs_err_lse": err_lse, "tol": TOL[dtype],
                "library_max_abs_err": err_lib,
                # device time (CUDA-graph replay); events around the eager calls as host_ms
                "kernel_ms": device_ms(lambda: rel_attention_fwd(qr, k, v, H, W, DKH)),
                "plain_ms": device_ms(lambda: rel_attention_fwd_plain(qr, k, v, H, W, DKH)),
                "library_ms": device_ms(library),
                "host_ms": time_ms(lambda: rel_attention_fwd(qr, k, v, H, W, DKH)),
                "library_host_ms": time_ms(library),
                **b1_bound(B * NH, H, W, dvh, dtype),
                "ok": ok,
            })
            r = rows[-1]
            print(f"kernel rel_attention_fwd {H}x{W} dvh={dvh} {r['dtype']}: "
                  f"err out {err_out:.3g} lse {err_lse:.3g} (tol {TOL[dtype]}) device ms: "
                  f"kernel {r['kernel_ms']:.4f} plain {r['plain_ms']:.4f} library "
                  f"{r['library_ms']:.4f} bound {r['bound_ms']:.5f} ({r['bound_by']}); eager "
                  f"kernel {r['host_ms']:.4f} library {r['library_host_ms']:.4f}", flush=True)
            del qr, k, v, bias, q
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return rows


RAGGED_MAPS = ((33, 17, 5), (72, 64, 2))   # (H, W, dvh) under and past the tensor-core rule


def ragged_phase():
    """B1 and B5 in bf16 at batch 1 x 8 heads on a ragged map under the
    tensor-core rule and one past it, against their plain versions (out and
    lse within TOL)."""
    from chexpert_tpu_torch.ops.fused_attention import (
        on_tensor_cores,
        rel_attention_fwd,
        rel_attention_fwd_plain,
    )
    from chexpert_tpu_torch.ops.hil_attention import (
        hil_attention_fwd,
        hil_attention_fwd_plain,
        hil_rel_operand,
        hil_slot,
    )

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(6)
    rows = []
    for H, W, dvh in RAGGED_MAPS:
        hw, slot = H * W, hil_slot(DKH, dvh)
        qr, k, v = kernel_inputs(H, W, dvh, dtype, gen, batch=1)
        got = rel_attention_fwd(qr, k, v, H, W, DKH)
        torch.cuda.synchronize()
        want = rel_attention_fwd_plain(qr, k, v, H, W, DKH)
        q = torch.randn(1, hw, NH, DKH, generator=gen) * DKH ** -0.5
        kv = torch.randn(1, hw, NH, DKH + dvh, generator=gen)
        pad = torch.zeros(1, hw, NH, slot - 2 * DKH - dvh)
        P = torch.cat([q, kv, pad], -1).reshape(1, hw, NH * slot).to(DEVICE, dtype)
        Rw = hil_rel_operand(torch.randn(DKH, 2 * W - 1, generator=gen).to(DEVICE), W)
        Rh = hil_rel_operand(torch.randn(DKH, 2 * H - 1, generator=gen).to(DEVICE), H)
        Rw, Rh = Rw.contiguous(), Rh.contiguous()
        geo = (H, W, DKH, dvh, slot)
        got5 = hil_attention_fwd(P, Rw, Rh, *geo)
        torch.cuda.synchronize()
        want5 = hil_attention_fwd_plain(P, Rw, Rh, *geo)
        err = {f"{name}_{part}": (a.float() - b.float()).abs().max().item()
               for name, (a2, b2) in (("b1", (got, want)), ("b5", (got5, want5)))
               for part, a, b in zip(("out", "lse"), a2, b2)}
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (*got, *got5))
        rows.append({"geometry": f"{H}x{W}", "dvh": dvh, "dtype": "bfloat16",
                     "tensor_cores": on_tensor_cores(dtype, H, W), "abs_err": err,
                     "tol": TOL[dtype], "ok": finite and max(err.values()) <= TOL[dtype]})
        print(f"kernel ragged {H}x{W} dvh={dvh} bf16 (tensor cores "
              f"{rows[-1]['tensor_cores']}): B1 / B5 err "
              f"{ {n: float(f'{e:.3g}') for n, e in err.items()} } (tol {TOL[dtype]})",
              flush=True)
        del qr, k, v, got, want, P, Rw, Rh, got5, want5
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B1 or B5 disagrees with its plain version on a ragged map: {bad}")
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
        hw = H * W
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

            def library_fwd(q_, k_, v_, bias_):
                return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias_, scale=1.0)

            lib_out = library_fwd(*leaves)

            def library():
                return torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)

            slow = {"reps": 5, "inner": 3}
            rows.append({
                "geometry": f"{H}x{W}", "H": H, "W": W, "hw": hw, "bn": bn, "dkh": DKH,
                "dvh": dvh, "layers": AA_LAYERS[(H, W, dvh)],
                "dtype": str(dtype).replace("torch.", ""), "abs_err": errs, "rel_err": rel,
                "tol": BWD_TOL[dtype], "ok": ok and fwd_ok,
                "fwd_abs_err": fwd_err, "fwd_tol": TOL[dtype], "fwd_ok": fwd_ok,
                # device time (CUDA-graph replay); events around eager calls as host_ms
                "dkdv_ms": device_ms(lambda: rel_attention_bwd_dkdv(*args), **slow),
                "dq_ms": device_ms(lambda: rel_attention_bwd_dq(*args), **slow),
                "dkdv_host_ms": time_ms(lambda: rel_attention_bwd_dkdv(*args)),
                "dq_host_ms": time_ms(lambda: rel_attention_bwd_dq(*args)),
                "dkdv_plain_ms": time_ms(lambda: rel_attention_bwd_dkdv_plain(*args)),
                "dq_plain_ms": time_ms(lambda: rel_attention_bwd_dq_plain(*args)),
                "fwd_ms": device_ms(lambda: rel_attention_fwd(qr, k, v, H, W, DKH)),
                "fwd_host_ms": time_ms(lambda: rel_attention_fwd(qr, k, v, H, W, DKH)),
                "library_ms": profiled_device_ms(library),
                "library_host_ms": time_ms(library),
                # each pass's share of the whole backward's bound ("b2")
                **{("b2" if k == "whole" else k): b
                   for k, b in b2_bounds(bn, H, W, dvh, dtype).items()},
            })
            r = rows[-1]
            print(f"kernel rel_attention_bwd {H}x{W} dvh={dvh} bn={bn} {r['dtype']}: rel err "
                  f"{ {n: float(f'{e:.3g}') for n, e in rel.items()} } (tol {r['tol']}) "
                  f"device ms dkdv {r['dkdv_ms']:.4f} (eager {r['dkdv_host_ms']:.4f}, plain "
                  f"{r['dkdv_plain_ms']:.4f}) dq {r['dq_ms']:.4f} (eager {r['dq_host_ms']:.4f}, "
                  f"plain {r['dq_plain_ms']:.4f}) library bwd {r['library_ms']:.4f} (eager "
                  f"{r['library_host_ms']:.4f}); bound dkdv {r['dkdv']['bound_ms']:.5f} "
                  f"dq {r['dq']['bound_ms']:.5f} ms; B1 at bn {bn} {r['fwd_ms']:.4f} ms "
                  f"(eager {r['fwd_host_ms']:.4f}), "
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


def dw_ragged_phase():
    """B3 and B4 in f32 and bf16 on DW_RAGGED against their plain versions
    (y, dx within DW_TOL, dw within DW_W_TOL of the largest value)."""
    from chexpert_tpu_torch.ops.depthwise import (
        depthwise_bwd,
        depthwise_bwd_plain,
        depthwise_fwd,
        depthwise_fwd_plain,
    )

    gen = torch.Generator().manual_seed(8)
    rows = []

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()

    def placed(t, lead):  # t's values in a contiguous view `lead` elements into a buffer
        out = torch.empty(t.numel() + lead, dtype=t.dtype, device=DEVICE)[lead:].view(t.shape)
        return out.copy_(t)

    for b, H, W, C, k, lead in DW_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            x = placed(torch.randn(b, C, H, W, generator=gen).to(DEVICE, dtype), lead)
            g = placed(torch.randn(b, C, H, W, generator=gen).to(DEVICE, dtype), 2 * lead)
            w = (torch.randn(C, 1, k, k, generator=gen) * 0.2).to(DEVICE)
            y = depthwise_fwd(x, w)
            dx, dw = depthwise_bwd(x, w, g)
            torch.cuda.synchronize()
            dx_p, dw_p = depthwise_bwd_plain(x, w, g)
            err = {"y": rel(y, depthwise_fwd_plain(x, w)), "dx": rel(dx, dx_p),
                   "dw": rel(dw, dw_p)}
            finite = all(bool(torch.isfinite(t.float()).all()) for t in (y, dx, dw))
            ok = (finite and err["y"] <= DW_TOL[dtype] and err["dx"] <= DW_TOL[dtype]
                  and err["dw"] <= DW_W_TOL)
            rows.append({"shape": [b, C, H, W], "k": k, "lead": lead,
                         "dtype": str(dtype).replace("torch.", ""), "rel_err": err, "ok": ok})
            print(f"kernel depthwise ragged {(b, C, H, W)} k={k} lead={lead} "
                  f"{rows[-1]['dtype']}: rel err "
                  f"{ {n: float(f'{e:.3g}') for n, e in err.items()} } (tol "
                  f"{DW_TOL[dtype]}, dw {DW_W_TOL})", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B3 or B4 disagrees with its plain version on a ragged shape: {bad}")
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
    avoid those; its backward by profiled_device_ms, the eager time beside
    it. B1 and B2's two
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
                    # max and sum 2, p.v 2*dvh, one exp; per RC entry 2*dkh
                    **bound(P.numel() * es + rel_bytes + out.numel() * es + lse.numel() * 4,
                            tok * hw * (2 * DKH + 4 + 2 * dvh) + tok * (W + H) * 2 * DKH,
                            dtype, tok * hw),
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
            drc, rc = hil_attention_bwd_dq(*args)  # pass 2 leaves the RC rows for pass 1
            leaves = [P.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()]
            lib_out = library_fwd(*leaves)
            b6b = b6_bounds(B_TRAIN, NH, H, W, dvh, slot, dtype)  # each pass's share
            row["dkdv"] = {
                "ms": device_ms(lambda: hil_attention_bwd_dkdv(*args, rc=rc), **slow),
                "plain_ms": device_ms(lambda: hil_attention_bwd_dkdv_plain(*pargs), **slow),
                **b6b["dkdv"]}
            row["dq"] = {
                "ms": device_ms(lambda: hil_attention_bwd_dq(*args), **slow),
                "plain_ms": device_ms(lambda: hil_attention_bwd_dq_plain(*pargs), **slow),
                **b6b["dq"]}
            row["drel"] = {
                "ms": device_ms(lambda: hil_attention_bwd_drel(P, drc, H, W, DKH, slot)),
                "plain_ms": device_ms(
                    lambda: hil_attention_bwd_drel_plain(P, drc, H, W, DKH, slot), **slow),
                **b6b["drel"]}
            row["bwd16"] = {
                "abs_err": errs, "rel_err": rel, "pads_zero": pads_zero, "finite": finite,
                "ms": row["dkdv"]["ms"] + row["dq"]["ms"] + row["drel"]["ms"],
                "host_ms": time_ms(lambda: hil_attention_bwd(P, Rw, Rh, out, lse, dout, *geo),
                                   reps=5, inner=3),
                "library_ms": profiled_device_ms(
                    lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)),
                "library_host_ms": time_ms(
                    lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True),
                    reps=5, inner=3),
                **b6b["whole"]}
            del leaves, lib_out, bias, drc, rc, dP, delta, P, out, lse, dout

            # the head-major kernels at the same geometry and batch, device time
            qr, kk, vv = kernel_inputs(H, W, dvh, dtype, gen, batch=B_TRAIN)
            o1, l1 = rel_attention_fwd(qr, kk, vv, H, W, DKH)
            d1 = torch.randn(o1.shape, generator=gen).to(DEVICE, dtype)
            a1 = (qr, kk, vv, d1, l1, attention_delta(o1, d1), H, W, DKH)
            row["bn_layout"] = {
                "b2_dkdv_ms": device_ms(lambda: rel_attention_bwd_dkdv(*a1), **slow),
                "b2_dq_ms": device_ms(lambda: rel_attention_bwd_dq(*a1), **slow)}
            for batch in (B, B_TRAIN):  # B1 beside its library call and its bound
                q1, k1, v1 = (t[:batch * NH].contiguous() for t in (qr, kk, vv))
                bias1 = (q1[..., DKH:DKH + W][..., col]
                         + q1[..., DKH + W:][..., krow]).contiguous()
                qq1 = q1[..., :DKH].contiguous()
                row["bn_layout"].update({
                    f"b1_ms_batch{batch}": device_ms(
                        lambda: rel_attention_fwd(q1, k1, v1, H, W, DKH)),
                    f"b1_library_ms_batch{batch}": device_ms(
                        lambda: F.scaled_dot_product_attention(qq1, k1, v1, attn_mask=bias1,
                                                               scale=1.0)),
                    f"b1_bound_batch{batch}": b1_bound(batch * NH, H, W, dvh, dtype)})
                del q1, k1, v1, bias1, qq1
            del qr, kk, vv, o1, l1, d1, a1
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
                  f"{f4['bound_ms']:.5f} {f4['bound_by']}); B5 b{B_TRAIN} {f16['ms']:.4f} "
                  f"(library {f16['library_ms']:.4f}, bound {f16['bound_ms']:.5f}); B1 b{B} "
                  f"{bn_l[f'b1_ms_batch{B}']:.4f} (library "
                  f"{bn_l[f'b1_library_ms_batch{B}']:.4f}, "
                  f"bound {bn_l[f'b1_bound_batch{B}']['bound_ms']:.5f}), b{B_TRAIN} "
                  f"{bn_l[f'b1_ms_batch{B_TRAIN}']:.4f} (library "
                  f"{bn_l[f'b1_library_ms_batch{B_TRAIN}']:.4f}); B6 b{B_TRAIN} dkdv "
                  f"{row['dkdv']['ms']:.4f} (plain {row['dkdv']['plain_ms']:.4f}, B2 "
                  f"{bn_l['b2_dkdv_ms']:.4f}) dq {row['dq']['ms']:.4f} (plain "
                  f"{row['dq']['plain_ms']:.4f}, B2 {bn_l['b2_dq_ms']:.4f}) drel "
                  f"{row['drel']['ms']:.4f} (plain {row['drel']['plain_ms']:.4f}); whole "
                  f"{bw['ms']:.4f} (bound {bw['bound_ms']:.5f}, library bwd "
                  f"{bw['library_ms']:.4f}, eager {bw['library_host_ms']:.4f}); eager ms B5 b{B} {f4['host_ms']:.4f}, B6 "
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
    calibrate_bn_on(model, x.permute(0, 3, 1, 2).contiguous())


def calibrate_bn_on(model, x) -> None:
    """calibrate_bn's work on a prepared (B, 3, H, W) batch on the card."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one forward sets the batch statistics
    with torch.no_grad():
        model.train()(x, generator=torch.Generator(device=DEVICE).manual_seed(0))
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
                per_step: dict, per_eval: dict, steps: int = TRAIN_STEPS, run: str = "run",
                extra: tuple = (), epochs=None):
    """The port's training CLI on the card (``extra``: more CLI flags); launch
    counts read just after: ``per_step`` launches per train step and
    ``per_eval`` per eval forward, and no launch of any other kernel.
    ``epochs`` (default ``steps``, one step an epoch): the epochs the
    ``steps`` steps span."""
    epochs = steps if epochs is None else epochs
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.chexpert import main as cli_main

    run_dir = os.path.join(data_dir, run)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["--train", "--evaluate_single_model", "--data_path", data_dir,
              "--output_dir", run_dir, "--model", model,
              "--image_size", str(image), "--compute_dtype", "bfloat16",
              "--batch_size", str(B_TRAIN), "--n_epochs", str(epochs),
              "--lr", str(lr), "--log_interval", "1",
              "--eval_interval", str(EVAL_INTERVAL), "--device", DEVICE, *extra])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [v for _, v in _scalars(run_dir, "train_loss")]
    ips = [v for _, v in _scalars(run_dir, "images_per_sec")]
    # one eval batch per evaluation: after each epoch, at each eval_interval, and the final one
    evals = epochs + steps // EVAL_INTERVAL + 1
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
          f"{os.environ.get(LAYOUT_ENV, 'bn')}{''.join(' ' + f for f in extra)}: "
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


def _ensemble_cli(data_dir: str, members: str, chunk: int) -> dict:
    """--evaluate_ensemble through cli.chexpert.main; launches read just after."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.chexpert import main as cli_main

    out = os.path.join(data_dir, f"ensemble_chunk{chunk}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["--evaluate_ensemble", "--restore", members, "--data_path", data_dir,
              "--output_dir", out, "--model", ENS_MODEL, "--image_size", str(IMAGE),
              "--compute_dtype", "bfloat16", "--batch_size", str(B_TRAIN),
              "--ensemble_member_chunk", str(chunk), "--device", DEVICE])
    torch.cuda.synchronize()
    path = os.path.join(out, "eval_results_ensemble.json")
    return {"counts": kernels.launch_counts(), "wall_s": time.perf_counter() - t0,
            "written": os.path.exists(path),
            "metrics": json.load(open(path)) if os.path.exists(path) else None}


def ensemble_phase(data_dir: str, smi: str) -> dict:
    """Phase 15: three seeded aadensenet121 members saved by the checkpoint
    store, evaluated through the CLI unchunked and at chunk 1; then, on the
    same members and batches, the ensemble's mean logits against the mean
    of the three single-model evaluate passes, and chunk 1 against chunk 3,
    in f32 (gated) and bf16 (reported)."""
    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.data import Batches, ChexpertIndex
    from chexpert_tpu_torch.eval.ensemble import (
        _plan_member_chunk,
        ensemble_outputs,
        list_checkpoints,
        load_member,
    )
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.ops.fused_attention import NAME
    from chexpert_tpu_torch.train import TrainState, eval_logits, prepare_image
    from chexpert_tpu_torch.train.loop import evaluate

    members = os.path.join(data_dir, "members")
    os.makedirs(members)
    for k in range(ENS_MEMBERS):
        sd = build_model(ENS_MODEL, image_size=IMAGE,
                         generator=torch.Generator().manual_seed(k)).state_dict()
        save_model_checkpoint(os.path.join(members, f"checkpoint_{k}.pt"), sd, k)
    n_batches = ENS_VALID // B_TRAIN
    per_pass = ENS_MEMBERS * 3 * n_batches  # members x AA transitions x valid batches
    runs = {chunk: _ensemble_cli(data_dir, members, chunk) for chunk in (0, 1)}

    dev = torch.device(DEVICE)
    model = build_model(ENS_MODEL, image_size=IMAGE, device=dev)
    batches = Batches(ChexpertIndex(data_dir, "valid"), B_TRAIN, image_size=IMAGE)
    paths = list_checkpoints(members)
    planned = _plan_member_chunk(model, len(paths), batches, dev, torch.bfloat16)
    timings = []
    ensemble_outputs(model, paths, batches, dev, torch.bfloat16, planned, ENS_MODEL, timings)
    ms_member_batch = (sum(t["seconds"] for t in timings) * 1e3
                       / sum(t["members"] * t["batches"] for t in timings))
    # one member's forward on a resident batch: events around the call, and
    # the profiler's device time (the host's share is the difference)
    member = load_member(model, paths[0], ENS_MODEL)
    image = prepare_image(torch.from_numpy(next(iter(batches))["image"]).to(dev))

    def member_forward():
        return eval_logits(member, image, torch.bfloat16)

    resident_ms = time_ms(member_forward, reps=5, inner=1)
    device_fwd_ms = profiled_device_ms(member_forward, reps=3)
    del member, image
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        ens = ensemble_outputs(model, paths, batches, dev, dtype, len(paths), ENS_MODEL)[0]
        one = ensemble_outputs(model, paths, batches, dev, dtype, 1, ENS_MODEL)[0]
        singles = [evaluate(TrainState(load_member(model, p, ENS_MODEL), None, None), batches,
                            dev, dtype)[0] for p in paths]
        mean = np.mean(np.stack(singles), axis=0)
        scale = float(np.abs(mean).max())
        errs[str(dtype).split(".")[-1]] = {
            "vs_single_passes": float(np.abs(ens - mean).max()) / scale,
            "chunk1_vs_all": float(np.abs(one - ens).max()) / scale}
    m0, m1 = runs[0]["metrics"], runs[1]["metrics"]
    metric_d = max(abs(m0[key][c] - m1[key][c]) for key in ("aucs", "loss") for c in m0[key]
                   if not (np.isnan(m0[key][c]) and np.isnan(m1[key][c])))
    checks = {
        "written": runs[0]["written"] and runs[1]["written"],
        # the unchunked run's planner measures one forward of the CLI's model
        # first (on a card; on the CPU it plans nothing)
        "launches_unchunked": runs[0]["counts"] == {NAME: per_pass + 3 * (dev.type == "cuda")},
        "launches_chunk1": runs[1]["counts"] == {NAME: per_pass},
        "f32_mean_of_single_passes": errs["float32"]["vs_single_passes"] <= ENS_TOL,
        "f32_chunk1_equals_unchunked": errs["float32"]["chunk1_vs_all"] <= ENS_TOL,
        "cli_chunk1_metrics_equal_unchunked": metric_d <= ENS_TOL,
    }
    print(f"ensemble {ENS_MEMBERS} x {ENS_MODEL} {IMAGE}x{IMAGE} bf16 batch {B_TRAIN}, "
          f"{n_batches} valid batches: CLI launches unchunked {runs[0]['counts']} / chunk 1 "
          f"{runs[1]['counts']} ({per_pass} = members x 3 B1 x batches, + 3 for the planning "
          f"forward); planned chunk {planned}; {ms_member_batch:.3f} ms per member per batch "
          f"(bf16, batch loop wall, decode overlapped), one member's forward on a resident "
          f"batch {resident_ms:.3f} ms (events) of which device {device_fwd_ms:.3f} ms "
          f"(profiler) on {smi}; mean logits vs the single "
          f"passes' mean, and chunk 1 vs unchunked, max |d| / max |logit|: {errs} (f32 gated "
          f"at {ENS_TOL}); CLI metrics chunk 1 vs unchunked max |d| {metric_d:.3g}; wall "
          f"{runs[0]['wall_s']:.1f} / {runs[1]['wall_s']:.1f} s; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"ensemble checks failed: {checks}")
    return {"counts": runs[0]["counts"], "counts_chunk1": runs[1]["counts"],
            "planned_chunk": planned, "ms_per_member_per_batch": ms_member_batch,
            "member_forward_resident_ms": resident_ms, "member_forward_device_ms": device_fwd_ms,
            "timings": timings, "errors": errs, "cli_metric_max_abs_d": metric_d,
            "wall_s": [runs[0]["wall_s"], runs[1]["wall_s"]], "members": members,
            "card": smi}


def predict_phase(data_dir: str, members: str, smi: str) -> dict:
    """Phase 16: cli.predict on a test csv of the fixture's valid images
    (absolute paths), for each checkpoint and for the directory."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.predict import main as predict_main
    from chexpert_tpu_torch.data import ATTR_NAMES, DIR_NAME
    from chexpert_tpu_torch.data.chexpert import read_csv, write_csv
    from chexpert_tpu_torch.ops.fused_attention import NAME

    header, rows = read_csv(os.path.join(data_dir, DIR_NAME, "valid.csv"))
    test_csv = os.path.join(data_dir, "test.csv")
    write_csv(test_csv, header, [[os.path.join(data_dir, r[0]), *r[1:]] for r in rows])
    studies = sorted({os.path.join(data_dir, r[0]).rsplit("/", 1)[0] for r in rows})
    n_batches = -(-len(rows) // B_TRAIN)
    out = {}
    for k in [*range(ENS_MEMBERS), "dir"]:
        restore = members if k == "dir" else os.path.join(members, f"checkpoint_{k}.pt")
        csv_path = os.path.join(data_dir, f"predict_{k}.csv")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        predict_main([test_csv, csv_path, "--restore_path", restore, "--model", ENS_MODEL,
                      "--image_size", str(IMAGE), "--batch_size", str(B_TRAIN),
                      "--compute_dtype", "bfloat16", "--device", DEVICE])
        torch.cuda.synchronize()
        got_header, got = read_csv(csv_path)
        out[k] = {"counts": kernels.launch_counts(), "wall_s": time.perf_counter() - t0,
                  "header": got_header, "studies": [r[0] for r in got],
                  "values": np.array([[float(v) for v in r[1:]] for r in got])}
    singles = [out[k]["values"] for k in range(ENS_MEMBERS)]
    dir_d = float(np.abs(out["dir"]["values"] - np.mean(singles, axis=0)).max())
    per_checkpoint = {NAME: 3 * n_batches}
    checks = {
        "header": all(o["header"] == ["Study", *ATTR_NAMES] for o in out.values()),
        "one_row_per_study": all(o["studies"] == studies for o in out.values()),
        "values_in_unit_interval": all(np.isfinite(o["values"]).all()
                                       and (o["values"] >= 0).all() and (o["values"] <= 1).all()
                                       for o in out.values()),
        "launches_per_checkpoint": all(out[k]["counts"] == per_checkpoint
                                       for k in range(ENS_MEMBERS)),
        "launches_directory": out["dir"]["counts"] == {NAME: 3 * n_batches * ENS_MEMBERS},
        "directory_is_the_mean": dir_d <= PREDICT_TOL,
    }
    print(f"predict {ENS_MODEL} {IMAGE}x{IMAGE} bf16 batch {B_TRAIN}: {len(rows)} images, "
          f"{len(studies)} studies; launches per checkpoint {out[0]['counts']}, directory "
          f"{out['dir']['counts']}; directory csv vs the checkpoints' mean max |d| "
          f"{dir_d:.3g} (tol {PREDICT_TOL}); wall {[round(o['wall_s'], 2) for o in out.values()]}"
          f" s on {smi}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"predict checks failed: {checks}")
    return {"counts": {str(k): o["counts"] for k, o in out.items()}, "directory_max_abs_d": dir_d,
            "wall_s": {str(k): o["wall_s"] for k, o in out.items()}, "card": smi}


def gradcam_phase(data_dir: str, smi: str, name: str, image: int, per_forward: dict,
                  route: dict, layout=None, calibrate=False, residual_gamma=None) -> dict:
    """Phase 17, one model: collect_visualization (Grad-CAM, probabilities,
    attention capture) through the CLI's Runner on the vis subset, bf16;
    launches read just after must be ``per_forward`` per vis batch and no
    other kernel (capture runs the einsum route). Then the f32 kernel route's
    CAM against the f32 plain route's (``route``) on the first vis batch.
    ``calibrate`` sets the seeded model's BatchNorm statistics from the vis
    images (the input the CAMs are taken on; statistics from other images
    leave a random efficientnet-b4's logits at ~1e5 there, where two f32
    routes part); ``residual_gamma`` damps the residual branches first."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.cli.chexpert import Runner, collect_visualization, config_from_args
    from chexpert_tpu_torch.data import Batches, ChexpertIndex
    from chexpert_tpu_torch.interpret import grad_cam
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.train import prepare_image

    model = build_model(name, image_size=image, generator=torch.Generator().manual_seed(0))
    if residual_gamma is not None:
        damp_residuals(model, residual_gamma)
    if calibrate:
        index = ChexpertIndex(data_dir, "vis")
        host = next(iter(Batches(index, len(index), image_size=image)))
        calibrate_bn_on(model.to(DEVICE), prepare_image(torch.from_numpy(host["image"])
                                                         .to(DEVICE)))
    ckpt = os.path.join(data_dir, f"{name}_vis.pt")
    save_model_checkpoint(ckpt, model.state_dict())
    del model
    with attn_layout_env(layout):
        runner = Runner(config_from_args([
            "--visualize", "--restore", ckpt, "--data_path", data_dir, "--output_dir",
            os.path.join(data_dir, f"vis_{name}"), "--model", name, "--image_size", str(image),
            "--batch_size", str(B), "--compute_dtype", "bfloat16", "--device", DEVICE]))
        vis_batches = runner.batches(runner.index("vis"), train=False)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        vis = collect_visualization(runner)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        x = prepare_image(torch.from_numpy(next(iter(vis_batches))["image"]).to(DEVICE))

        def cam_bf16():
            return grad_cam(runner.state.model, x, compute_dtype=torch.bfloat16)

        ms_per_batch = time_ms(cam_bf16, reps=5, inner=1)
        device_per_batch = profiled_device_ms(cam_bf16, reps=3)
        cam_k, logits_k = grad_cam(runner.state.model, x, compute_dtype=torch.float32)
    ref = build_model(name, image_size=image, **route)
    ref.load_state_dict(runner.state.model.state_dict(), strict=True)
    cam_r, logits_r = grad_cam(ref.to(DEVICE), x, compute_dtype=torch.float32)
    cam_d = (cam_k - cam_r).abs().max().item()
    logit_d = ((logits_k - logits_r).abs().max() / logits_r.abs().max()).item()
    cams, n = vis["cams"], len(vis["images"])
    row_err = max((float(np.abs(w.sum(-1) - 1).max()) for w in vis["attn_weights"]), default=0.0)
    n_batches = len(vis_batches)
    checks = {
        "launches_per_vis_batch": counts == {k: v * n_batches for k, v in per_forward.items()},
        "cams": (cams.shape == (n, 1, image, image) and bool(np.isfinite(cams).all())
                 and float(cams.min()) >= 0.0 and float(cams.max()) <= 1.0),
        "probs": bool(np.isfinite(vis["probs"]).all()) and vis["probs"].shape == (n, 5),
        "captured": (len(vis["attn_weights"]) == sum(per_forward.values())
                     if name != EFF else vis["attn_weights"] == []),
        "captured_rows_sum_to_1": row_err <= ROW_SUM_TOL,
        "f32_cam_vs_plain_route": cam_d <= CAM_TOL,
    }
    shapes = sorted({tuple(w.shape) for w in vis["attn_weights"]})
    print(f"gradcam {name} {image}x{image} bf16 batch {B} layout {layout or 'bn'}: {n} vis images "
          f"in {n_batches} batches; launches {counts} (want {per_forward} per batch, none else); "
          f"CAM range [{float(cams.min()):.4g}, {float(cams.max()):.4g}], mean "
          f"{float(cams.mean()):.4g}; captured {len(vis['attn_weights'])} layers {shapes}, row "
          f"sums max |d| {row_err:.3g}; {ms_per_batch:.3f} ms per vis batch (Grad-CAM alone, "
          f"bf16, events around the call) of which device {device_per_batch:.3f} ms "
          f"(profiler) on {smi}; collect wall {wall_s:.2f} s; f32 kernel "
          f"route vs {route}: CAM max |d| {cam_d:.3g} (tol {CAM_TOL}), logits max |d| / max "
          f"|logit| {logit_d:.3g}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"gradcam {name} checks failed: {checks}")
    del runner, ref, vis
    torch.cuda.empty_cache()
    return {"counts": counts, "vis_images": n, "vis_batches": n_batches,
            "ms_per_vis_batch": ms_per_batch, "device_ms_per_vis_batch": device_per_batch,
            "collect_wall_s": wall_s,
            "f32_cam_max_abs_d": cam_d, "f32_logit_rel_d": logit_d, "row_sum_max_abs_d": row_err,
            "card": smi}


@contextlib.contextmanager
def launch_env(rank: int, world: int, port: int):
    """torchrun's variables for one rank on card 0 (every rank of a world
    that shares the one card has local rank 0), restored afterwards."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def recorded_process_groups():
    """Record the (backend, world size) of every process group init."""
    import torch.distributed as dist

    calls, init = [], dist.init_process_group

    def record(backend=None, *args, **kwargs):
        calls.append((str(backend), kwargs.get("world_size")))
        return init(backend, *args, **kwargs)

    dist.init_process_group = record
    try:
        yield calls
    finally:
        dist.init_process_group = init


def ddp_args(data_dir: str, run_dir: str, lr: float, steps: int) -> list:
    """Phase 18(b)'s CLI run: f32, global batch DDP_BATCH, one step per
    epoch on the DDP_BATCH-image fixture, eval and checkpoint after every
    step (the tracker keeps each step's parameters)."""
    return ["--train", "--evaluate_single_model", "--data_path", data_dir,
            "--output_dir", run_dir, "--model", "aadensenet121", "--image_size", str(IMAGE),
            "--compute_dtype", "float32", "--batch_size", str(DDP_BATCH),
            "--n_epochs", str(steps), "--lr", str(lr), "--log_interval", "1",
            "--eval_interval", "1", "--device", DEVICE]


def ddp_worker(argv) -> int:
    """One rank of phase 18(b), in its own process (argv: rank, world, port,
    steps, lr, data dir, run dir, out): joins a gloo group of ``world`` ranks
    on card 0, runs cli.chexpert.main --multihost, and writes
    to ``out``: its launch counts, its launches by kernel and bn, its local
    train losses, and its global BatchNorm calls by (training, on CUDA)."""
    rank, world, port, steps = (int(a) for a in argv[:4])
    lr = float(argv[4])
    data_dir, run_dir, out = argv[5:8]
    import torch.distributed as dist

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.chexpert import main as cli_main
    from chexpert_tpu_torch.parallel.sync_bn import GlobalBatchNorm2d
    from chexpert_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    bn_calls, shapes, losses = {}, {}, []
    bn_forward, launch, train_step = GlobalBatchNorm2d.forward, kernels.launch, loop.train_step

    def counted_bn(self, x):
        key = f"training={self.training} cuda={x.is_cuda}"
        bn_calls[key] = bn_calls.get(key, 0) + 1
        return bn_forward(self, x)

    def shaped_launch(name, fn, pointers, ints, device):
        key = f"{name} bn={ints[0]}"
        shapes[key] = shapes.get(key, 0) + 1
        return launch(name, fn, pointers, ints, device)

    def recorded_step(state, batch, *args):
        loss = train_step(state, batch, *args)
        losses.append(float(loss))
        return loss

    GlobalBatchNorm2d.forward = counted_bn
    kernels.launch = shaped_launch
    loop.train_step = recorded_step
    with launch_env(rank, world, port):
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
        try:
            kernels.reset_launch_counts()
            cli_main([*ddp_args(data_dir, run_dir, lr, steps), "--multihost"])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"rank": rank, "counts": counts, "launches_by_bn": shapes,
                   "local_losses": losses, "global_bn_calls": bn_calls}, f)
    return 0


def _steady_ms(run_dir: str, batch: int) -> float:
    """ms per step from the median images/s of steps 2.. (rank 0's log; the
    first step includes the kernel library loads and cuDNN's planning)."""
    ips = [v for _, v in _scalars(run_dir, "images_per_sec")]
    return batch / statistics.median(ips[1:] or ips) * 1e3


@contextlib.contextmanager
def first_input_moved_one_ulp():
    """The train loop's first step sees its input images moved by one ulp
    (toward +inf): the noise of a one-ulp change of the input."""
    from chexpert_tpu_torch.train import loop

    step = loop.train_step

    def moved(state, batch, *args):
        if state.step == 0:
            image = batch["image"]
            batch = {**batch, "image": torch.nextafter(image, torch.full_like(image, np.inf))}
        return step(state, batch, *args)

    loop.train_step = moved
    try:
        yield
    finally:
        loop.train_step = step


def _state_ratios(got: dict, ref: dict, init: dict) -> dict:
    """Per floating tensor of a state dict, |got - ref| over |ref - init|: the
    max over the max ("max") and the L2 norm over the L2 norm ("l2")."""
    out = {}
    for key, r in ref.items():
        if not r.is_floating_point():
            continue
        d, change = (got[key] - r).double(), (r - init[key]).double()
        out[key] = {"max": (d.abs().max() / change.abs().max().clamp_min(1e-30)).item(),
                    "l2": (d.norm() / change.norm().clamp_min(1e-30)).item()}
    return out


def _ratio_summary(ratios: dict) -> dict:
    summary = {}
    for kind in ("max", "l2"):
        vals = {k: v[kind] for k, v in ratios.items()}
        worst = max(vals, key=vals.get)
        summary[kind] = {"worst": vals[worst], "worst_tensor": worst,
                         "median": statistics.median(vals.values())}
    return summary


def nccl_world1_phase(smi: str, phase5_ms: float) -> dict:
    """Phase 18(a): phase 5's run through cli.chexpert.main --multihost as
    world 1 under NCCL (torchrun's variables), 3 steps."""
    from chexpert_tpu_torch.data import make_synthetic_dataset
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME

    per_step = {NAME: 3, BWD_DKDV: 3, BWD_DQ: 3}
    with tempfile.TemporaryDirectory(dir=ROOT) as d:  # phase 5's fixture and lr
        make_synthetic_dataset(d, n_train=B_TRAIN, n_valid=B_TRAIN, image_size=IMAGE)
        with launch_env(0, 1, free_port()), recorded_process_groups() as groups:
            nccl = train_phase(d, smi, "aadensenet121", IMAGE, TRAIN_LR, per_step, {NAME: 3},
                               steps=MP_TRAIN_STEPS, run="run_nccl", extra=("--multihost",))
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if groups != [(backend, 1)]:
        raise AssertionError(f"phase 18(a) made process groups {groups}, not one {backend} "
                             "group of world 1")
    print(f"multi-process (a): world 1, NCCL, --multihost: {nccl['ms_per_step']:.2f} ms/step "
          f"beside phase 5's {phase5_ms:.2f} ms/step (aadensenet121 {IMAGE}x{IMAGE} bf16 batch "
          f"{B_TRAIN}, this call) on {smi}", flush=True)
    return {**nccl, "phase5_ms_per_step": phase5_ms}


def _states_by_step(run_dir: str) -> dict:
    """global step -> state dict of every checkpoint the tracker kept."""
    from chexpert_tpu_torch.checkpoint import load_model_checkpoint

    cks = [load_model_checkpoint(str(p)) for p in Path(run_dir, "best_checkpoints").glob("*.pt")]
    return {ck["global_step"]: ck["state_dict"] for ck in cks}


def ddp_phase(smi: str, lr: float = DDP_LR, steps: int = DDP_STEPS) -> dict:
    """Phase 18(b): world 2 under gloo on the one card (NCCL refuses two
    ranks on one device), each rank a process of its own, against world 1 in
    this process, f32, TF32 off; beside it, world 1 again with the first
    input moved by one ulp, the noise floor of the comparison."""
    from collections import Counter

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.cli.chexpert import main as cli_main
    from chexpert_tpu_torch.data import make_synthetic_dataset
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME

    per_step = {NAME: 3, BWD_DKDV: 3, BWD_DQ: 3}
    world = 2
    names = ("world1", f"world{world}", "ulp")
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=DDP_BATCH, n_valid=DDP_BATCH, image_size=IMAGE)
        runs = {k: os.path.join(d, k) for k in names}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cli_main(ddp_args(d, runs["world1"], lr, steps))
        torch.cuda.synchronize()
        world1_wall = time.perf_counter() - t0
        world1_counts = kernels.launch_counts()
        with first_input_moved_one_ulp():
            cli_main(ddp_args(d, runs["ulp"], lr, steps))
        port = free_port()
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        t0 = time.perf_counter()
        # each rank's output goes to a file, not a pipe: a rank blocked on a
        # full pipe would hold the other in its next collective
        logs = [os.path.join(d, f"rank{r}.log") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), WORKER_FLAG, str(r),
                         str(world), str(port), str(steps), str(lr), d, runs[f"world{world}"],
                         outs[r]], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + DDP_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world2_wall = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(logs[r]) as log:
                    raise AssertionError(f"phase 18(b) rank {r} exited {p.returncode}:\n"
                                         f"{log.read()[-6000:]}")
        ranks = [json.load(open(o)) for o in outs]
        init = build_model("aadensenet121", image_size=IMAGE,
                           generator=torch.Generator().manual_seed(0)).state_dict()
        states = {k: _states_by_step(runs[k]) for k in names}
        losses = {k: [v for _, v in _scalars(runs[k], "train_loss")] for k in names}
        records = {k: Counter((r["tag"], r["step"]) for r in map(
            json.loads, open(os.path.join(runs[k], "scalars.jsonl"))) if "step" in r)
            for k in names}
        files = {k: sorted(str(p.relative_to(runs[k])) for p in Path(runs[k]).rglob("*")
                           if p.is_file()) for k in names}
        ms = {k: _steady_ms(runs[k], DDP_BATCH) for k in names[:2]}
    evals = 2 * steps + 1  # after each epoch, at each step's interval, the final one
    want = {k: 3 * steps + 3 * evals * (k == NAME) for k in per_step}
    rank_bn = DDP_BATCH // world * NH
    ref = losses["world1"]

    def loss_d(key, upto=None):
        return max(abs(a - b) for a, b in zip(losses[key][:upto], ref[:upto])) / max(ref)

    # parameters and BN statistics after each step, against world 1's
    state = {k: {step: _ratio_summary(_state_ratios(states[k][step], states["world1"][step],
                                                    init))
                 for step in sorted(states["world1"])} for k in names[1:]}
    two = state[f"world{world}"]
    local_mean = [statistics.fmean(step) for step in zip(*(r["local_losses"] for r in ranks))]
    bn_calls = [r["global_bn_calls"] for r in ranks]
    checks = {
        "steps": all(len(losses[k]) == steps and sorted(states[k]) == list(range(1, steps + 1))
                     for k in names),
        "first_loss_within_tol": loss_d(f"world{world}", 1) <= DDP_FIRST_LOSS_TOL,
        "losses_within_tol": loss_d(f"world{world}") <= max(DDP_LOSS_TOL,
                                                            NOISE_FACTOR * loss_d("ulp")),
        "params_within_tol": all(
            two[k]["max"]["median"]
            <= max(GRAD_TOL, NOISE_FACTOR * state["ulp"][k]["max"]["median"]) for k in two),
        "logged_loss_is_ranks_mean": max(abs(a - b) for a, b in
                                         zip(local_mean, losses[f"world{world}"]))
                                     <= 1e-6 * max(ref),
        "rank_launches": [r["counts"] for r in ranks] == [want] * world,
        "rank_launches_at_bn": all(set(r["launches_by_bn"]) == {f"{k} bn={rank_bn}" for k in want}
                                   for r in ranks),
        "one_set_of_artifacts": (files[f"world{world}"] == files["world1"]
                                 and records[f"world{world}"] == records["world1"]),
        "global_bn_on_cuda": all(c.get("training=True cuda=True", 0) > 0
                                 and "training=True cuda=False" not in c for c in bn_calls),
    }

    def fmt(summary):
        return {step: {kind: (float(f"{v['worst']:.3g}"), v["worst_tensor"],
                              float(f"{v['median']:.3g}")) for kind, v in by.items()}
                for step, by in summary.items()}

    print(f"multi-process (b): world {world} under gloo on one card vs world 1, aadensenet121 "
          f"{IMAGE}x{IMAGE} f32 (TF32 off) global batch {DDP_BATCH}, {steps} steps at lr "
          f"{lr}: losses world {world} {losses[f'world{world}']} vs world 1 {ref}, max |d| / "
          f"max loss: step 1 {loss_d(f'world{world}', 1):.3g} (tol {DDP_FIRST_LOSS_TOL}), all "
          f"{loss_d(f'world{world}'):.3g} (tol {DDP_LOSS_TOL} or {NOISE_FACTOR} x the noise "
          f"floor's); parameters and BN statistics after each step, |d| / |change| per tensor "
          f"(worst, its tensor, median) by max and L2: {fmt(two)} (tol on each step's median "
          f"max: {GRAD_TOL} or {NOISE_FACTOR} x the noise floor's); noise floor, world 1 "
          f"with its first input moved one ulp: losses {losses['ulp']}, max |d| / max loss "
          f"step 1 {loss_d('ulp', 1):.3g}, all {loss_d('ulp'):.3g}, state {fmt(state['ulp'])}; "
          f"rank launches {[r['launches_by_bn'] for r in ranks]} (want {want} at bn {rank_bn}); "
          f"world 1 launches {world1_counts}; global BN calls {bn_calls}; ms/step world {world} "
          f"{ms[f'world{world}']:.2f}, world 1 {ms['world1']:.2f} (f32 batch {DDP_BATCH}, rank "
          f"0's images/s), wall {world2_wall:.1f} s (2 processes) / {world1_wall:.1f} s on "
          f"{smi}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"multi-process checks failed: {checks}")
    return {"world2_gloo": {"lr": lr, "steps": steps, "losses": losses[f"world{world}"],
                            "world1_losses": ref, "one_ulp_losses": losses["ulp"],
                            "first_loss_max_rel_d": loss_d(f"world{world}", 1),
                            "loss_max_rel_d": loss_d(f"world{world}"),
                            "one_ulp_loss_max_rel_d": loss_d("ulp"),
                            "state_by_step": two, "one_ulp_state_by_step": state["ulp"],
                            "ms_per_step": ms[f"world{world}"],
                            "world1_ms_per_step": ms["world1"],
                            "wall_s": world2_wall, "world1_wall_s": world1_wall,
                            "ranks": ranks, "world1_counts": world1_counts},
            "counts": {f"train aadensenet121 world 2 gloo rank {r['rank']}": r["counts"]
                       for r in ranks},
            "card": smi}



# ---------------------------------------------------------------------------
# phase 19: the CIFAR bench (cli.bench) and its kernel geometries
# ---------------------------------------------------------------------------

BENCH_BATCH, BENCH_IMAGE = 256, 32          # the bench's default batch, CIFAR's images
# (subcommand and architecture, more flags): the bench runs of phase 19
BENCH_WRN = ("wideresnet", "28", "10", "--attn")
BENCH_SHORT = (("resnet", "50", "--attn"), ("densenet", "12", "100", "--attn"),
               ("efficientnet", "b0"))
BENCH_WRN_STEPS = 8                         # the --mini_data overfit (one step an epoch)
BENCH_SHORT_EPOCHS = 2                      # --synthetic: 512 train images, 2 steps an epoch
# WideResNet-28-10 with the head widths the card once refused (ROADMAP C.17):
# --attn_nh 2 gives (dkh, dvh) (32, 16) at 16x16 and (64, 32) at 8x8, trained
# as BENCH_WRN is; --attn_k 0.33 gives dkh 26, the ragged width, for
# BENCH_RAGGED_STEPS steps under bn
BENCH_WRN_NH2 = (*BENCH_WRN, "--attn_nh", "2")
BENCH_WRN_RAGGED = (*BENCH_WRN, "--attn_k", "0.33")
BENCH_RAGGED_STEPS = 2
# heads past the largest width class (ROADMAP C.18), which the kernels take
# in chunks of the head dimensions: (160, 64) at 16x16 and (320, 128) at
# 8x8, trained as BENCH_WRN is; (320, 160) and (640, 320) for
# BENCH_RAGGED_STEPS steps under bn
BENCH_WRN_WIDE = (*BENCH_WRN, "--attn_k", "0.5", "--attn_v", "0.2", "--attn_nh", "1")
BENCH_WRN_WIDER = (*BENCH_WRN, "--attn_k", "1.0", "--attn_v", "0.5", "--attn_nh", "1")
# the kernels at every head-width class, batch 256 x 2 heads (the --attn_nh 2
# bench's B*nh): (H, W, dvh, dkh), the --attn_k 0.3 / 0.33, --attn_nh 4 and
# --attn_v 0.2 heads at 16x16 and 8x8, --attn_nh 2's at both, --attn_nh 1's
# widest at 8x8; then heads past the largest class: BENCH_WRN_WIDE's at
# their maps, densenet 12 100's ragged (150, 75) and resnet 50's (512, 256)
# under --attn_k 1.0 --attn_v 0.5 --attn_nh 1
WIDTH_NH = 2
WIDTH_GEOS = tuple((n, n, dvh, dkh)
                   for dkh, dvh in ((24, 8), (26, 8), (32, 16), (20, 16), (64, 32))
                   for n in (16, 8)) + ((8, 8, 64, 128),)
WIDE_GEOS = ((16, 16, 64, 160), (8, 8, 128, 320), (8, 8, 75, 150), (1, 1, 256, 512))


def bench_model(argv):
    """The bench's model for a subcommand (f32, on the CPU, seeded 0) and
    its geometries: AA convs as (H, W, dvh, dkh) and stride-1 depthwise convs
    as (H, C, k), each in model order."""
    from chexpert_tpu_torch.cli import bench
    from chexpert_tpu_torch.models import AAConv2d
    from chexpert_tpu_torch.models.efficientnet import DepthwiseConv

    args = bench.build_parser().parse_args(list(argv) + ["--synthetic"])
    model, _, _ = bench.build_bench_model(args, 100, 1)
    aa = [(*m.input_dims, m.dv // m.nh, m.dk // m.nh) for m in model.modules()
          if isinstance(m, AAConv2d)]
    dw = []
    if any(isinstance(m, DepthwiseConv) for m in model.modules()):
        dw = dw_stride1_layers(f"efficientnet-{args.architecture}", BENCH_IMAGE)
    return model, aa, dw


def _hil_inputs(H, W, dvh, batch, dtype, gen, dkh=DKH, nh=NH):
    """(P, Rw, Rh, geo) of B5 / B6 at batch x nh heads, seeded."""
    from chexpert_tpu_torch.ops.hil_attention import hil_rel_operand, hil_slot

    hw, slot = H * W, hil_slot(dkh, dvh)
    q = torch.randn(batch, hw, nh, dkh, generator=gen) * dkh ** -0.5
    k = torch.randn(batch, hw, nh, dkh, generator=gen)
    v = torch.randn(batch, hw, nh, dvh, generator=gen)
    pad = torch.zeros(batch, hw, nh, slot - 2 * dkh - dvh)
    P = torch.cat([q, k, v, pad], -1).reshape(batch, hw, nh * slot).to(DEVICE, dtype)
    Rw = hil_rel_operand((torch.randn(dkh, 2 * W - 1, generator=gen) + dkh ** -0.5)
                         .to(DEVICE), W).contiguous()
    Rh = hil_rel_operand((torch.randn(dkh, 2 * H - 1, generator=gen) + dkh ** -0.5)
                         .to(DEVICE), H).contiguous()
    return P, Rw, Rh, (H, W, dkh, dvh, slot)


def _rel_err(names, got, want) -> dict:
    """max |got - want| / max(1, max |want|) per named output."""
    return {n: ((g.float() - w.float()).abs().max()
                / max(1.0, w.float().abs().max().item())).item()
            for n, g, w in zip(names, got, want)}


ATTENTION_PASSES = ("fwd", "dq", "dkdv", "drel")


def pass_registers(source: str, cls) -> dict:
    """Registers and spill stores of the kernels of ``source``'s library for
    the width class ``cls``, by the pass that each kernel's name carries
    (ATTENTION_PASSES), from the ``-Xptxas -v`` report of the library's
    build (kernels.ptxas_report): per pass the most over its kernels (every
    route, dtype and compile-time tile of that pass, the one that ran among
    them) and how many there are."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.ops.fused_attention import width_defines

    found = {p: [] for p in ATTENTION_PASSES}
    for r in kernels.ptxas_report((source, width_defines(cls))):
        name = r["kernel"].replace("(anonymous namespace)::", "").replace("void ", "", 1)
        words = re.split(r"[<(]", name)[0].split("::")[-1].split("_")
        for p in ATTENTION_PASSES:
            if p in words:
                found[p].append(r)
    return {p: {"registers": max((r.get("registers", 0) for r in rs), default=None),
                "spill_stores": max((r.get("spill_stores", 0) for r in rs), default=None),
                "kernels": len(rs)}
            for p, rs in found.items()}


def forward_registers(source: str, plan) -> dict:
    """Registers and spill stores of the tensor-core wide forward's instance
    that ``plan`` (fused_attention.wide_fwd_plan) runs, by its kernel name
    (``fwd_tc_kernel<N>``, N = fused_attention.fwd_instance) in the report
    of the (128, 64) library of ``source`` (kernels.ptxas_report)."""
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.ops.fused_attention import WIDTH_CLASSES, fwd_instance, width_defines

    name = f"fwd_tc_kernel<{fwd_instance(plan)}>"
    found = [r for r in kernels.ptxas_report((source, width_defines(WIDTH_CLASSES[-1])))
             if name in r["kernel"]]
    return {"kernel": name, "registers": found[0].get("registers") if found else None,
            "spill_stores": found[0].get("spill_stores") if found else None}


def bench_attention_rows(geos, nh=NH, time_f32=False):
    """B1, B2's two passes, B5 and B6's three passes at each (H, W, dvh, dkh)
    of ``geos`` and BENCH_BATCH x nh heads, f32 and bf16, against their plain
    versions within the bounds of phases 2, 3 and 11 (TOL on out and lse;
    BWD_TOL on the backward relative to max(1, max |plain|)); bf16 device
    times (f32 too with ``time_f32``) beside the plain versions, the library
    call (scaled_dot_product_attention with the bias materialized; its
    backward by the profiler) and the bound at the real head widths; each
    row names the width class whose library ran."""
    from chexpert_tpu_torch.ops.fused_attention import (
        attention_delta,
        key_positions,
        on_tensor_cores,
        rel_attention_bwd,
        rel_attention_bwd_dkdv,
        rel_attention_bwd_dkdv_plain,
        rel_attention_bwd_dq,
        rel_attention_bwd_dq_plain,
        rel_attention_bwd_plain,
        rel_attention_fwd,
        rel_attention_fwd_plain,
        wide_fwd_plan,
        width_plan,
    )
    from chexpert_tpu_torch.ops.hil_attention import (
        hil_attention_bwd,
        hil_attention_bwd_dkdv,
        hil_attention_bwd_dq,
        hil_attention_bwd_drel,
        hil_attention_bwd_plain,
        hil_attention_delta,
        hil_attention_fwd,
        hil_attention_fwd_plain,
    )

    gen = torch.Generator().manual_seed(19)
    batch, slow = BENCH_BATCH, {"reps": 5, "inner": 3}
    rows = []
    for H, W, dvh, dkh in geos:
        hw, bn = H * W, batch * nh
        for dtype in (torch.float32, torch.bfloat16):
            timed = dtype == torch.bfloat16 or time_f32
            cls, nk, nv = width_plan(dkh, dvh)
            row = {"geometry": f"{H}x{W}", "H": H, "W": W, "dvh": dvh, "dkh": dkh, "bn": bn,
                   "width_class": cls, "chunks": (nk, nv),
                   "dtype": str(dtype).replace("torch.", ""),
                   "tensor_cores": on_tensor_cores(dtype, H, W)}
            # head-major: B1, B2
            qr, k, v = kernel_inputs(H, W, dvh, dtype, gen, batch=batch, dkh=dkh, nh=nh)
            out, lse = rel_attention_fwd(qr, k, v, H, W, dkh)
            torch.cuda.synchronize()
            out_p, lse_p = rel_attention_fwd_plain(qr, k, v, H, W, dkh)
            b1_err = {"out": (out.float() - out_p.float()).abs().max().item(),
                      "lse": (lse - lse_p).abs().max().item()}
            del out_p, lse_p
            dout = torch.randn(out.shape, generator=gen).to(DEVICE, dtype)
            got = rel_attention_bwd(qr, k, v, out, lse, dout, H, W, dkh)
            torch.cuda.synchronize()
            b2_err = _rel_err(("dqr", "dk", "dv"), got,
                              rel_attention_bwd_plain(qr, k, v, out, lse, dout, H, W, dkh))
            finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, *got))
            del got
            row["b1"] = {"abs_err": b1_err}
            row["b2"] = {"rel_err": b2_err}
            if timed:
                col, krow = key_positions(hw, W, qr.device)
                bias = (qr[..., dkh:dkh + W][..., col] + qr[..., dkh + W:][..., krow]).contiguous()
                q = qr[..., :dkh].contiguous()
                delta = attention_delta(out, dout)
                args = (qr, k, v, dout, lse, delta, H, W, dkh)
                leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
                lib_out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                                         scale=1.0)
                b2b = b2_bounds(bn, H, W, dvh, dtype, dkh)
                row["b1"].update({
                    "ms": device_ms(lambda: rel_attention_fwd(qr, k, v, H, W, dkh)),
                    "plain_ms": device_ms(lambda: rel_attention_fwd_plain(qr, k, v, H, W, dkh),
                                          **slow),
                    "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=bias, scale=1.0)),
                    **b1_bound(bn, H, W, dvh, dtype, dkh)})
                lib_bwd = profiled_device_ms(
                    lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True))
                row["b2"].update({
                    "dkdv": {"ms": device_ms(lambda: rel_attention_bwd_dkdv(*args), **slow),
                             "plain_ms": device_ms(lambda: rel_attention_bwd_dkdv_plain(*args),
                                                   **slow),
                             **b2b["dkdv"]},
                    "dq": {"ms": device_ms(lambda: rel_attention_bwd_dq(*args), **slow),
                           "plain_ms": device_ms(lambda: rel_attention_bwd_dq_plain(*args),
                                                 **slow),
                           **b2b["dq"]},
                    "library_ms": lib_bwd})
                row["b2"]["whole"] = {"ms": row["b2"]["dkdv"]["ms"] + row["b2"]["dq"]["ms"],
                                      **b2b["whole"]}
                del bias, q, delta, args, leaves, lib_out
            del qr, k, v, out, lse, dout
            # heads-in-lanes: B5, B6
            P, Rw, Rh, geo = _hil_inputs(H, W, dvh, batch, dtype, gen, dkh=dkh, nh=nh)
            out, lse = hil_attention_fwd(P, Rw, Rh, *geo)
            torch.cuda.synchronize()
            out_p, lse_p = hil_attention_fwd_plain(P, Rw, Rh, *geo)
            b5_err = {"out": (out.float() - out_p.float()).abs().max().item(),
                      "lse": (lse - lse_p).abs().max().item()}
            del out_p, lse_p
            dout = torch.randn(out.shape, generator=gen).to(DEVICE, dtype)
            got = hil_attention_bwd(P, Rw, Rh, out, lse, dout, *geo)
            torch.cuda.synchronize()
            b6_err = _rel_err(("dP", "dRw", "dRh"), got,
                              hil_attention_bwd_plain(P, Rw, Rh, out, lse, dout, *geo))
            pads = got[0].view(batch, hw, nh, geo[4])[..., 2 * dkh + dvh:]
            finite = (finite and int(torch.count_nonzero(pads)) == 0
                      and all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, *got)))
            del got, pads
            row["b5"] = {"abs_err": b5_err}
            row["b6"] = {"rel_err": b6_err}
            if timed:
                slot = geo[4]
                delta = hil_attention_delta(out, dout, nh)
                dP = torch.empty_like(P)
                args = (P, Rw, Rh, dout, lse, delta, dP, *geo)
                drc, rc = hil_attention_bwd_dq(*args)
                b6b = b6_bounds(batch, nh, H, W, dvh, slot, dtype, dkh)
                row["b5"].update({
                    "ms": device_ms(lambda: hil_attention_fwd(P, Rw, Rh, *geo)),
                    "plain_ms": device_ms(lambda: hil_attention_fwd_plain(P, Rw, Rh, *geo),
                                          **slow),
                    **b5_bound(batch, nh, H, W, dvh, slot, dtype, dkh)})
                row["b6"].update({
                    "dq": {"ms": device_ms(lambda: hil_attention_bwd_dq(*args), **slow),
                           **b6b["dq"]},
                    "dkdv": {"ms": device_ms(lambda: hil_attention_bwd_dkdv(*args, rc=rc),
                                             **slow),
                             **b6b["dkdv"]},
                    "drel": {"ms": device_ms(lambda: hil_attention_bwd_drel(P, drc, H, W, dkh,
                                                                            slot, dvh)),
                             **b6b["drel"]},
                    "plain_ms": device_ms(
                        lambda: hil_attention_bwd_plain(P, Rw, Rh, out, lse, dout, *geo), **slow)})
                row["b6"]["whole"] = {
                    "ms": sum(row["b6"][k]["ms"] for k in ("dq", "dkdv", "drel")),
                    **b6b["whole"]}
                del delta, dP, args, drc, rc
            del P, Rw, Rh, out, lse, dout
            torch.cuda.empty_cache()
            row["ok"] = (finite and max(max(b1_err.values()), max(b5_err.values())) <= TOL[dtype]
                         and max(max(b2_err.values()), max(b6_err.values())) <= BWD_TOL[dtype])
            row["registers"] = {
                f"{k} {p}": pass_registers(src, cls)[p]
                for k, src, ps in (("b1", "rel_attention_fwd", ("fwd",)),
                                   ("b2", "rel_attention_bwd", ("dkdv", "dq")),
                                   ("b5", "hil_attention_fwd", ("fwd",)),
                                   ("b6", "hil_attention_bwd", ("dq", "dkdv", "drel")))
                for p in ps}
            plan = (wide_fwd_plan(H, W, dkh, dvh, bn) if dtype == torch.bfloat16
                    and (nk, nv) != (1, 1) else None)
            if plan is not None:  # the wide forward's own instance, beside each pass's most
                row["fwd_plan"] = plan
                for k, src in (("b1", "rel_attention_fwd"), ("b5", "hil_attention_fwd")):
                    row["registers"][f"{k} fwd_tc"] = forward_registers(src, plan)
            rows.append(row)
            regs = row["registers"]
            times = ""
            if timed:
                times = (f"; device ms B1 {row['b1']['ms']:.4f} (plain {row['b1']['plain_ms']:.4f}"
                         f", library {row['b1']['library_ms']:.4f}, bound "
                         f"{row['b1']['bound_ms']:.5f}) B2 dkdv {row['b2']['dkdv']['ms']:.4f} dq "
                         f"{row['b2']['dq']['ms']:.4f} (bound of the whole "
                         f"{row['b2']['whole']['bound_ms']:.5f}, library bwd "
                         f"{row['b2']['library_ms']:.4f}) B5 {row['b5']['ms']:.4f} (bound "
                         f"{row['b5']['bound_ms']:.5f}) B6 dq {row['b6']['dq']['ms']:.4f} dkdv "
                         f"{row['b6']['dkdv']['ms']:.4f} drel {row['b6']['drel']['ms']:.4f} "
                         f"(bound of the whole {row['b6']['whole']['bound_ms']:.5f})")
            print(f"kernel bench attention {H}x{W} dkh={dkh} dvh={dvh} bn={bn} {row['dtype']} "
                  f"(class {row['width_class']}, chunks {row['chunks']}, tensor cores "
                  f"{row['tensor_cores']}): B1 err "
                  f"{ {n: float(f'{e:.3g}') for n, e in b1_err.items()} } B5 err "
                  f"{ {n: float(f'{e:.3g}') for n, e in b5_err.items()} } (tol {TOL[dtype]}); "
                  f"B2 rel err { {n: float(f'{e:.3g}') for n, e in b2_err.items()} } B6 rel err "
                  f"{ {n: float(f'{e:.3g}') for n, e in b6_err.items()} } (tol "
                  f"{BWD_TOL[dtype]}){times}; registers / spill stores (most over the "
                  f"pass's kernels) "
                  f"{ {k: (r['registers'], r['spill_stores']) for k, r in regs.items()} }",
                  flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"an attention kernel disagrees with its plain version at a "
                             f"bench geometry: {bad}")
    return rows


def bench_depthwise_rows(geos):
    """B3 and B4 at each (H, C, k) of ``geos`` and BENCH_BATCH, f32 and bf16,
    against their plain versions within DW_TOL / DW_W_TOL (as phase 7);
    bf16 device times beside the plain versions, the library calls and the
    bound."""
    from chexpert_tpu_torch.ops.depthwise import (
        depthwise_bwd,
        depthwise_bwd_plain,
        depthwise_fwd,
        depthwise_fwd_plain,
    )

    gen = torch.Generator().manual_seed(20)
    batch, rows = BENCH_BATCH, []

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()

    for H, C, k in geos:
        p = k // 2
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.finfo(dtype).bits // 8
            x = torch.randn(batch, C, H, H, generator=gen).to(DEVICE, dtype)
            g = torch.randn(batch, C, H, H, generator=gen).to(DEVICE, dtype)
            w = (torch.randn(C, 1, k, k, generator=gen) * 0.2).to(DEVICE)
            y = depthwise_fwd(x, w)
            dx, dw = depthwise_bwd(x, w, g)
            torch.cuda.synchronize()
            dx_p, dw_p = depthwise_bwd_plain(x, w, g)
            err = {"y": rel(y, depthwise_fwd_plain(x, w)), "dx": rel(dx, dx_p),
                   "dw": rel(dw, dw_p)}
            finite = all(bool(torch.isfinite(t.float()).all()) for t in (y, dx, dw))
            row = {"geometry": f"{H}x{H}", "C": C, "k": k, "batch": batch,
                   "dtype": str(dtype).replace("torch.", ""), "rel_err": err,
                   "ok": (finite and err["y"] <= DW_TOL[dtype] and err["dx"] <= DW_TOL[dtype]
                          and err["dw"] <= DW_W_TOL)}
            del y, dx, dw, dx_p, dw_p
            if dtype == torch.bfloat16:
                w_lib, n = w.to(dtype), x.numel()
                row["fwd"] = {
                    "ms": device_ms(lambda: depthwise_fwd(x, w)),
                    "plain_ms": device_ms(lambda: depthwise_fwd_plain(x, w)),
                    "library_ms": device_ms(lambda: F.conv2d(x, w_lib, padding=p, groups=C)),
                    **bound(2 * n * es + w.numel() * 4, 2 * k * k * n, torch.float32)}
                row["bwd"] = {
                    "ms": device_ms(lambda: depthwise_bwd(x, w, g)),
                    "plain_ms": device_ms(lambda: depthwise_bwd_plain(x, w, g)),
                    "library_ms": device_ms(lambda: torch.ops.aten.convolution_backward(
                        g, x, w_lib, None, [1, 1], [p, p], [1, 1], False, [0, 0], C,
                        [True, True, False])),
                    **bound(3 * n * es + 2 * w.numel() * 4, 4 * k * k * n, torch.float32)}
            rows.append(row)
            times = ("" if "fwd" not in row else
                     f"; device ms B3 {row['fwd']['ms']:.4f} (plain {row['fwd']['plain_ms']:.4f}, "
                     f"library {row['fwd']['library_ms']:.4f}, bound "
                     f"{row['fwd']['bound_ms']:.5f}) B4 {row['bwd']['ms']:.4f} (plain "
                     f"{row['bwd']['plain_ms']:.4f}, library {row['bwd']['library_ms']:.4f}, "
                     f"bound {row['bwd']['bound_ms']:.5f})")
            print(f"kernel bench depthwise {H}x{H} C={C} k={k} batch {batch} {row['dtype']}: "
                  f"rel err { {n: float(f'{e:.3g}') for n, e in err.items()} } (tol "
                  f"{DW_TOL[dtype]}, dw {DW_W_TOL}){times}", flush=True)
            del x, g, w
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B3 or B4 disagrees with its plain version at a bench geometry: "
                             f"{bad}")
    return rows


def bench_layer_phase(argv, layout, per_layer: dict) -> dict:
    """f32, TF32 off, at the bench's batch: one train-mode forward and
    backward of the bench model on the plain route (einsum attention,
    library depthwise) captures each AA conv's and stride-1 depthwise conv's
    input and upstream gradient; then each such layer alone, on the kernel
    route (attention in ``layout``) and on the plain route, from that input
    and gradient. The output and every gradient (input and parameters) must
    agree within GRAD_TOL of the largest value, as phases 6, 10 and 14 gate;
    each layer's kernel route launches ``per_layer``. A gradient that is
    zero on the plain route (the relative embeddings of a 1x1 map, where the
    softmax has one key and every logit's gradient is 0) is held to
    GRAD_TOL of the layer's largest gradient: the kernels round ds = p (dp -
    delta) to f32 noise there, not to 0."""
    import copy

    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.models import AAConv2d
    from chexpert_tpu_torch.models.efficientnet import DepthwiseConv

    torch.backends.cudnn.deterministic = True
    model, aa, dw = bench_model(argv)
    model = model.to(DEVICE).train()

    def sites():
        for name, mod in model.named_modules():
            if isinstance(mod, AAConv2d):
                yield name, mod, "attn_impl", "einsum", "pallas"
            elif isinstance(mod, DepthwiseConv) and mod.stride == 1:
                yield name, mod, "dw_impl", "library", "kernel"

    captured, handles = [], []
    for name, mod, attr, plain, kernel in sites():
        setattr(mod, attr, plain)

        def hook(m, inputs, out, name=name, attr=attr, plain=plain, kernel=kernel):
            rec = {"module": m, "name": name, "attr": attr, "routes": (plain, kernel),
                   "x": inputs[0].detach().clone()}
            out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
            captured.append(rec)
        handles.append(mod.register_forward_hook(hook))
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(BENCH_BATCH, 3, BENCH_IMAGE, BENCH_IMAGE, generator=gen).to(DEVICE)
    y = torch.randint(0, 100, (BENCH_BATCH,), generator=gen).to(DEVICE)
    kernels.reset_launch_counts()
    F.cross_entropy(model(x, generator=torch.Generator(device=DEVICE).manual_seed(0)),
                    y).backward()
    torch.cuda.synchronize()
    plain_counts = kernels.launch_counts()
    for h in handles:
        h.remove()
    del model
    err, counts, zero_ref = {}, [], []
    for rec in captured:
        res = {}
        for route in rec["routes"]:
            mod = copy.deepcopy(rec["module"])
            setattr(mod, rec["attr"], route)
            if rec["attr"] == "attn_impl":
                mod.attn_layout = layout
            xi = rec["x"].clone().requires_grad_()
            kernels.reset_launch_counts()
            out = mod(xi)
            out.backward(rec["g"])
            torch.cuda.synchronize()
            if route == rec["routes"][1]:
                counts.append(kernels.launch_counts())
            res[route] = {"out": out.detach(), "x": xi.grad,
                          **{n: p.grad for n, p in mod.named_parameters()}}
            del mod, xi, out
        got, ref = res[rec["routes"][1]], res[rec["routes"][0]]
        layer_scale = max(t.abs().max().item() for t in ref.values())
        for n in ref:
            scale = ref[n].abs().max().item()
            if scale == 0.0:  # analytically zero: softmax over one key
                zero_ref.append(f"{rec['name']}.{n}")
                scale = layer_scale
            err[f"{rec['name']}.{n}"] = (got[n] - ref[n]).abs().max().item() / scale
        del res, got, ref
    n_sites = len(aa) + len(dw)
    checks = {"plain_route_no_launch": plain_counts == {},
              "layers_captured": len(captured) == n_sites and n_sites > 0,
              "layer_launches": counts == [per_layer] * n_sites,
              "layers_within_tol": max(err.values()) <= GRAD_TOL}
    worst = max(err, key=err.get)
    print(f"bench layers {' '.join(argv)} layout {layout} f32 batch {BENCH_BATCH}: {n_sites} "
          f"layers (AA {aa}, depthwise {dw}), kernel vs plain route on the captured input and "
          f"upstream grad: worst max|d|/max {err[worst]:.3g} ({worst}), median "
          f"{statistics.median(err.values()):.3g}, tol {GRAD_TOL} (zero on the plain route, "
          f"held to the layer's largest gradient: {zero_ref}); checks {checks}", flush=True)
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"bench layer checks failed for {argv} {layout}: {checks}")
    return {"layers": n_sites, "worst": err[worst], "worst_tensor": worst,
            "median": statistics.median(err.values()), "zero_on_plain_route": zero_ref}


# groups of a profiled step's device kernels, by the first pattern in the name
KERNEL_GROUPS = (("attention", ("attention_",)), ("depthwise", ("depthwise_",)),
                 ("layout copies", ("nchwToNhwc", "nhwcToNchw")),
                 ("batch norm", ("batch_norm",)),
                 ("conv and gemm", ("xmma", "gemm", "conv", "cutlass", "cudnn")))


def kernel_group(name: str) -> str:
    return next((g for g, pats in KERNEL_GROUPS if any(p in name for p in pats)), "other")


def bench_run(argv, layout, smi: str, per_step: dict, per_eval: dict, steps: int,
              extra=(), profile_steps=(2, 4)) -> dict:
    """cli.bench.main on the card, bf16, at the bench's batch, with
    ``--synthetic``. Each train step, eval forward and the attention capture
    are wrapped to read the launches they make; each step is timed on the
    host clock between synchronizations, and steps ``profile_steps`` run
    under the profiler for the device time per step, by kernel and by
    KERNEL_GROUPS. Gates: ``steps``
    steps, finite losses, ``per_step`` launches per step, ``per_eval`` per
    eval forward, none on the capture. Where matplotlib is missing the
    attention maps are captured and not drawn: ``save_attn_maps`` is
    replaced by a recorder of the weights' shapes."""
    from torch.profiler import ProfilerActivity, profile

    from chexpert_tpu_torch import interpret, kernels
    from chexpert_tpu_torch.cli import bench

    rec = {"step": [], "eval": [], "capture": [], "ms": [], "device_ms": [], "wall_ms": [],
           "top_kernels_ms": [], "groups_ms": []}

    def counted(kind, fn):
        def run(*a, **kw):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            prof = None
            if kind == "step" and len(rec["step"]) in range(*profile_steps):
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if prof is not None:
                prof.__exit__(None, None, None)
                avgs = prof.key_averages()
                attr = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
                        else "self_cuda_time_total")
                dev = sorted(((getattr(e, attr) / 1e3, e.key) for e in avgs
                              if e.device_type == torch.autograd.DeviceType.CUDA
                              and not getattr(e, "is_user_annotation", False)), reverse=True)
                rec["device_ms"].append(sum(t for t, _ in dev))
                rec["top_kernels_ms"].append([(name[:80], t) for t, name in dev[:8]])
                groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
                for t, name in dev:
                    groups[kernel_group(name)] += t
                rec["groups_ms"].append(groups)
                rec["wall_ms"].append(ms)
            elif kind == "step":
                rec["ms"].append(ms)
            after = kernels.launch_counts()
            rec[kind].append({k: after[k] - before.get(k, 0) for k in after
                              if after[k] != before.get(k, 0)})
            return out
        return run

    originals = (bench.train_step, bench.eval_logits, interpret.capture_attention_weights,
                 interpret.save_attn_maps)
    bench.train_step = counted("step", bench.train_step)
    bench.eval_logits = counted("eval", bench.eval_logits)
    interpret.capture_attention_weights = counted("capture", interpret.capture_attention_weights)
    rendered = importlib.util.find_spec("matplotlib") is not None
    maps = []
    if not rendered:  # no matplotlib on this host: keep what would be drawn
        interpret.save_attn_maps = lambda x, w, *a, **kw: maps.append(
            [tuple(t.shape) for t in w])
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d, attn_layout_env(layout):
            run_dir = os.path.join(d, "bench")
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            bench.main([*argv, "--synthetic", "--train", "--device", DEVICE,
                        "--output_dir", run_dir, "--log_interval", "1", *extra])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            losses = [v for _, v in _scalars(run_dir, "train_loss")]
            evals = {t: [v for _, v in _scalars(run_dir, t)]
                     for t in ("eval_loss", "acc@top1", "acc@top5")}
            vis = sorted(os.listdir(os.path.join(run_dir, "vis"))) if os.path.isdir(
                os.path.join(run_dir, "vis")) else []
            artifacts = all(os.path.exists(os.path.join(run_dir, a)) for a in
                            ("config.json", "scalars.jsonl", "checkpoint.pt",
                             "optim_checkpoint.pt"))
    finally:
        (bench.train_step, bench.eval_logits, interpret.capture_attention_weights,
         interpret.save_attn_maps) = originals
    steady = rec["ms"][1:] or rec["ms"]  # the first step builds kernels' tables, plans cuDNN
    ms_step = statistics.median(steady)
    device_step = statistics.median(rec["device_ms"]) if rec["device_ms"] else float("nan")
    attention_step = (statistics.median(g["attention"] for g in rec["groups_ms"])
                      if rec["groups_ms"] else float("nan"))
    checks = {
        "steps": len(rec["step"]) == steps and len(losses) == steps,
        "losses_finite": bool(np.isfinite(losses).all()),
        "launches_per_step": rec["step"] == [per_step] * steps,
        "launches_per_eval_forward": rec["eval"] == [per_eval] * len(rec["eval"])
                                     and len(rec["eval"]) > 0,
        "no_launch_on_capture": all(c == {} for c in rec["capture"]),
        "vis_attn": "--vis_attn" not in extra or (
            len(rec["capture"]) == 1 and (len(vis) > 0 if rendered else len(maps) == 8)),
        "artifacts": artifacts,
    }
    out = {"argv": list(argv), "layout": layout or "bn", "losses": losses, "evals": evals,
           "counts": counts, "per_step_launches": per_step, "per_eval_launches": per_eval,
           "eval_forwards": len(rec["eval"]), "captures": len(rec["capture"]),
           "ms_per_step": ms_step, "step_ms": rec["ms"],
           "device_ms_per_step": device_step, "profiled_wall_ms": rec["wall_ms"],
           "attention_ms_per_step": attention_step,
           "top_kernels_ms": rec["top_kernels_ms"], "device_ms_by_group": rec["groups_ms"],
           "busy_share": device_step / ms_step, "images_per_sec": BENCH_BATCH / ms_step * 1e3,
           "peak_gib": peak_gib, "wall_s": wall_s, "vis_files": len(vis),
           "attn_maps_rendered": rendered, "attn_maps_unrendered": maps, "card": smi}
    print(f"bench {' '.join(argv)} {' '.join(extra)} layout {out['layout']} bf16 batch "
          f"{BENCH_BATCH}: losses {[round(x, 4) for x in losses]}; eval {evals}; launches per "
          f"step {rec['step'][-1] if rec['step'] else {}} (want {per_step}), per eval forward "
          f"{rec['eval'][-1] if rec['eval'] else {}} (want {per_eval}), {len(rec['capture'])} "
          f"captures; {ms_step:.2f} ms/step (median after the first; steps "
          f"{[round(t, 2) for t in rec['ms']]}), device {device_step:.2f} ms/step (profiler; "
          f"attention kernels {attention_step:.2f}), "
          f"busy {out['busy_share']:.3f}, {out['images_per_sec']:.1f} img/s, peak "
          f"{peak_gib:.2f} GiB, wall {wall_s:.1f} s, {len(vis)} vis files (matplotlib "
          f"{'present' if rendered else f'absent: {len(maps)} calls kept'}), on {smi}; checks "
          f"{checks}; top device kernels of the profiled step (ms) "
          f"{[(n, round(t, 3)) for n, t in (rec['top_kernels_ms'] or [[]])[-1]]}, by group "
          f"{ {g: round(t, 3) for g, t in (rec['groups_ms'] or [{}])[-1].items()} }", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"bench {argv} {layout} checks failed: {checks}")
    return out


def bench_phase(smi: str) -> dict:
    """Phase 19: the kernels at every geometry of the bench runs, each bench
    layer on the kernel route against the plain route, then the bench runs
    themselves through cli.bench.main."""
    from chexpert_tpu_torch.ops.depthwise import BWD as DW_BWD
    from chexpert_tpu_torch.ops.depthwise import FWD as DW_FWD
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME
    from chexpert_tpu_torch.ops.hil_attention import BWD_PASSES as HIL_PASSES
    from chexpert_tpu_torch.ops.hil_attention import FWD as HIL_FWD

    geos = {}
    for argv in (BENCH_WRN, *BENCH_SHORT, BENCH_WRN_NH2, BENCH_WRN_RAGGED, BENCH_WRN_WIDE,
                 BENCH_WRN_WIDER):
        _, aa, dw = bench_model(argv)
        geos[" ".join(argv)] = {"aa": aa, "dw": dw}
    # the rows at NH heads: the default models' geometries (the wider heads'
    # are among WIDTH_GEOS)
    attn_geos = list(dict.fromkeys(g for a in (BENCH_WRN, *BENCH_SHORT)
                                   for g in geos[" ".join(a)]["aa"]))
    dw_geos = list(dict.fromkeys(g for m in geos.values() for g in m["dw"]))
    print(f"bench geometries at {BENCH_IMAGE}x{BENCH_IMAGE}, batch {BENCH_BATCH}: {geos}",
          flush=True)
    for argv, want in ((BENCH_WRN_NH2, {(16, 16, 16, 32), (8, 8, 32, 64)}),
                       (BENCH_WRN_RAGGED, {(16, 16, 4, 20), (8, 8, 8, 26)}),
                       (BENCH_WRN_WIDE, {(16, 16, 64, 160), (8, 8, 128, 320)}),
                       (BENCH_WRN_WIDER, {(16, 16, 160, 320), (8, 8, 320, 640)})):
        if set(geos[" ".join(argv)]["aa"]) != want:
            raise AssertionError(f"{argv}: AA convs {geos[' '.join(argv)]['aa']} are not {want}")
    attn_rows = bench_attention_rows(attn_geos)
    width_rows = bench_attention_rows(WIDTH_GEOS + WIDE_GEOS, nh=WIDTH_NH, time_f32=True)
    dw_rows = bench_depthwise_rows(dw_geos)

    def launches(argv, layout):
        n_aa, n_dw = len(geos[" ".join(argv)]["aa"]), len(geos[" ".join(argv)]["dw"])
        if n_dw:
            return {DW_FWD: n_dw, DW_BWD: n_dw}, {DW_FWD: n_dw}, {DW_FWD: 1, DW_BWD: 1}
        if layout == "hil":
            return ({HIL_FWD: n_aa, **{p: n_aa for p in HIL_PASSES}}, {HIL_FWD: n_aa},
                    {HIL_FWD: 1, **{p: 1 for p in HIL_PASSES}})
        return ({NAME: n_aa, BWD_DKDV: n_aa, BWD_DQ: n_aa}, {NAME: n_aa},
                {NAME: 1, BWD_DKDV: 1, BWD_DQ: 1})

    cases = ([(BENCH_WRN, "bn"), (BENCH_WRN, "hil")] + [(a, "bn") for a in BENCH_SHORT]
             + [(BENCH_WRN_NH2, "bn"), (BENCH_WRN_NH2, "hil"), (BENCH_WRN_RAGGED, "bn"),
                (BENCH_WRN_WIDE, "bn"), (BENCH_WRN_WIDE, "hil"), (BENCH_WRN_WIDER, "bn")])
    layers = {f"{' '.join(a)} {lay}": bench_layer_phase(a, lay, launches(a, lay)[2])
              for a, lay in cases}
    runs = {}
    for argv, layout in cases:
        per_step, per_eval, _ = launches(argv, layout)
        if argv in (BENCH_WRN_RAGGED, BENCH_WRN_WIDER):
            runs[f"{' '.join(argv)} {layout}"] = bench_run(
                argv, layout, smi, per_step, per_eval, BENCH_RAGGED_STEPS,
                extra=("--mini_data", "--n_epochs", str(BENCH_RAGGED_STEPS),
                       "--lr_warmup_epochs", "0"), profile_steps=(1, 2))
        elif argv in (BENCH_WRN, BENCH_WRN_NH2, BENCH_WRN_WIDE):
            runs[f"{' '.join(argv)} {layout}"] = bench_run(
                argv, layout, smi, per_step, per_eval, BENCH_WRN_STEPS,
                extra=("--mini_data", "--n_epochs", str(BENCH_WRN_STEPS), "--lr_warmup_epochs",
                       "0", "--evaluate", "--vis_attn"))
            losses = runs[f"{' '.join(argv)} {layout}"]["losses"]
            if not losses[-1] < losses[0]:
                raise AssertionError(f"bench {argv} {layout}: the overfit loss did not fall: "
                                     f"{losses}")
        else:
            runs[f"{' '.join(argv)} {layout}"] = bench_run(
                argv, layout, smi, per_step, per_eval, 2 * BENCH_SHORT_EPOCHS,
                extra=("--n_epochs", str(BENCH_SHORT_EPOCHS)), profile_steps=(2, 3))
    return {"geometries": geos, "attention_rows": attn_rows, "width_rows": width_rows,
            "depthwise_rows": dw_rows, "layers": layers, "runs": runs}



# ---------------------------------------------------------------------------
# phase 20: the fast input path (packed cache, native decode, device crop,
# --profile) and --pretrained
# ---------------------------------------------------------------------------

PROFILE_BATCHES = 4                         # phase 20(c): train batches an epoch, 2 epochs
PIPELINE_EPOCHS = 3                         # epochs the input pipelines are timed over


def pipeline_ms(make, epochs: int = PIPELINE_EPOCHS) -> float:
    """Median host ms per batch of iterating ``make(epoch)``'s batches (the
    pipeline alone, no device): every batch of ``epochs`` epochs, the first
    epoch's first batch (pool start-up, page cache) left out."""
    times = []
    for epoch in range(epochs):
        it = iter(make(epoch))
        while True:
            t0 = time.perf_counter()
            try:
                next(it)
            except StopIteration:
                break
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def input_phase(smi: str, phase5_ms: float) -> dict:
    """Phase 20 on phase 5's model and fixture: aadensenet121 320x320 bf16
    batch 16 through cli.chexpert.main with (a) --packed_cache, (b)
    --packed_cache --data_aug --device_aug (the crop and flip in the train
    step: every step's batch arrives as 352x352 stored tiles) and (c) (a)
    with --profile over 2 epochs of PROFILE_BATCHES steps (the trace opens
    before step 3 and closes at the epoch's end): phase 5's launches per
    step and eval forward, falling loss, and (c) a trace file. The input
    pipelines timed alone, ms per batch: Batches (JPEG decode, host
    augment), PackedBatches (host crop) and PackedBatches(emit_stored=True);
    the decoder that ran. Then --pretrained: a seeded densenet121 saved in
    the legacy torchvision format (norm.1 / conv.2 keys, an ImageNet head,
    no num_batches_tracked) as $CHEXPERT_TPU_PRETRAINED_DIR/densenet121.pth,
    one train step of densenet121 --pretrained: the parameters and
    statistics the step starts from equal the file's, the head excepted."""
    from chexpert_tpu_torch import native
    from chexpert_tpu_torch.data import Batches, ChexpertIndex, make_synthetic_dataset
    from chexpert_tpu_torch.data.chexpert import DIR_NAME
    from chexpert_tpu_torch.data.packed import PackedBatches, build_packed_cache
    from chexpert_tpu_torch.models import build_model, normalize_state_dict
    from chexpert_tpu_torch.ops.fused_attention import BWD_DKDV, BWD_DQ, NAME
    from chexpert_tpu_torch.train import loop, steps

    per_step, per_eval = {NAME: 3, BWD_DKDV: 3, BWD_DQ: 3}, {NAME: 3}
    out = {"decoder": "native libjpeg" if native.available() else "PIL", "card": smi}
    crops = []
    augment = steps.device_augment

    def counting_augment(img, generator, size):
        crops.append(tuple(img.shape))
        return augment(img, generator, size)

    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=B_TRAIN, n_valid=B_TRAIN, image_size=IMAGE)
        out["a_packed"] = train_phase(d, smi, "aadensenet121", IMAGE, TRAIN_LR, per_step,
                                      per_eval, run="run_packed", extra=("--packed_cache",))
        steps.device_augment = counting_augment
        try:
            out["b_packed_device_aug"] = train_phase(
                d, smi, "aadensenet121", IMAGE, TRAIN_LR, per_step, per_eval, run="run_dev_aug",
                extra=("--packed_cache", "--data_aug", "--device_aug"))
        finally:
            steps.device_augment = augment
        stored = (B_TRAIN, IMAGE + 32, IMAGE + 32, 1)
        if crops != [stored] * TRAIN_STEPS:
            raise AssertionError(f"phase 20(b): device_augment saw {crops}, not {TRAIN_STEPS} "
                                 f"batches of {stored}")
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=PROFILE_BATCHES * B_TRAIN, n_valid=B_TRAIN,
                               image_size=IMAGE)
        c = train_phase(d, smi, "aadensenet121", IMAGE, TRAIN_LR, per_step, per_eval,
                        steps=2 * PROFILE_BATCHES, epochs=2, run="run_profile",
                        extra=("--packed_cache", "--profile"))
        trace = os.path.join(d, "run_profile", "profile", "trace.json")
        c["trace_bytes"] = os.path.getsize(trace) if os.path.exists(trace) else 0
        if not c["trace_bytes"]:
            raise AssertionError(f"phase 20(c): no trace at {trace}")
        out["c_packed_profile"] = c
        # the input pipelines alone, on the train split at batch 16 (host clock)
        index = ChexpertIndex(d, "train")
        cache = os.path.join(d, DIR_NAME, "packed")
        tiles = build_packed_cache(index, cache, image_size=IMAGE, pack_margin=32)
        centre = build_packed_cache(index, cache, image_size=IMAGE, pack_margin=0)
        out["pipeline_ms_per_batch"] = {
            "Batches (JPEG, host augment)": pipeline_ms(lambda e: Batches(
                index, B_TRAIN, shuffle=True, augment=True, image_size=IMAGE, epoch=e,
                drop_last=True)),
            "Batches (JPEG)": pipeline_ms(lambda e: Batches(
                index, B_TRAIN, shuffle=True, image_size=IMAGE, epoch=e, drop_last=True)),
            "PackedBatches (host crop)": pipeline_ms(lambda e: PackedBatches(
                index, tiles, B_TRAIN, image_size=IMAGE, shuffle=True, augment=True, epoch=e,
                drop_last=True)),
            "PackedBatches (centre)": pipeline_ms(lambda e: PackedBatches(
                index, centre, B_TRAIN, image_size=IMAGE, shuffle=True, epoch=e,
                drop_last=True)),
            "PackedBatches(emit_stored=True)": pipeline_ms(lambda e: PackedBatches(
                index, tiles, B_TRAIN, image_size=IMAGE, shuffle=True, emit_stored=True,
                epoch=e, drop_last=True)),
        }
    # --pretrained
    start = []
    step_fn = loop.train_step

    def first_step(state, *a, **kw):
        if not start:
            start.append({k: v.detach().cpu().clone() for k, v in
                          state.model.state_dict().items()})
        return step_fn(state, *a, **kw)

    ref = build_model("densenet121", generator=torch.Generator().manual_seed(1)).state_dict()
    legacy = {}
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        k = k.replace("norm1.", "norm.1.").replace("norm2.", "norm.2.").replace(
            "conv1.", "conv.1.").replace("conv2.", "conv.2.") if "denselayer" in k else k
        legacy[k] = v
    legacy["classifier.weight"] = torch.randn(1000, ref["classifier.weight"].shape[1])
    legacy["classifier.bias"] = torch.zeros(1000)
    old_env = os.environ.get("CHEXPERT_TPU_PRETRAINED_DIR")
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        torch.save(legacy, os.path.join(d, "densenet121.pth"))
        os.environ["CHEXPERT_TPU_PRETRAINED_DIR"] = d
        make_synthetic_dataset(d, n_train=B_TRAIN, n_valid=B_TRAIN, image_size=IMAGE)
        loop.train_step = first_step
        try:
            from chexpert_tpu_torch.cli.chexpert import main as cli_main

            cli_main(["--train", "--pretrained", "--data_path", d, "--output_dir",
                      os.path.join(d, "run"), "--model", "densenet121", "--image_size",
                      str(IMAGE), "--batch_size", str(B_TRAIN), "--n_epochs", "1",
                      "--log_interval", "1", "--eval_interval", "0", "--device", DEVICE])
        finally:
            loop.train_step = step_fn
            if old_env is None:
                os.environ.pop("CHEXPERT_TPU_PRETRAINED_DIR", None)
            else:
                os.environ["CHEXPERT_TPU_PRETRAINED_DIR"] = old_env
        loaded = normalize_state_dict(legacy, "densenet121")
        compared = [k for k in ref if not k.startswith("classifier.")
                    and not k.endswith("num_batches_tracked")]
        diff = max((start[0][k] - loaded[k]).abs().max().item() for k in compared)
        head_kept = start[0]["classifier.weight"].shape == ref["classifier.weight"].shape
        losses = [v for _, v in _scalars(os.path.join(d, "run"), "train_loss")]
    out["pretrained"] = {"tensors_compared": len(compared), "max_abs_diff": diff,
                         "head_is_the_models": head_kept, "losses": losses}
    print(f"pretrained densenet121 {IMAGE}x{IMAGE}: {len(compared)} tensors of the legacy "
          f"torchvision file against the step's start, max |d| {diff:.3g}; head kept "
          f"{head_kept}; loss {losses}", flush=True)
    if not (diff == 0.0 and head_kept and len(losses) == 1 and np.isfinite(losses).all()):
        raise AssertionError(f"phase 20 --pretrained failed: {out['pretrained']}")
    ms = {"phase 5 (JPEG)": phase5_ms, "(a) --packed_cache": out["a_packed"]["ms_per_step"],
          "(b) --packed_cache --data_aug --device_aug":
              out["b_packed_device_aug"]["ms_per_step"]}
    out["ms_per_step"] = ms
    print(f"input path aadensenet121 {IMAGE}x{IMAGE} bf16 batch {B_TRAIN}, decoder "
          f"{out['decoder']}: pipeline alone ms per batch "
          f"{ {k: round(v, 3) for k, v in out['pipeline_ms_per_batch'].items()} }; train ms/step "
          f"{ {k: round(v, 2) for k, v in ms.items()} }; (c) trace {c['trace_bytes']} bytes; "
          f"on {smi}", flush=True)
    return out


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
    from chexpert_tpu_torch.ops import kernel_targets
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
    took = kernels.build(kernel_targets())
    build_s = time.perf_counter() - t0
    print(f"card: {smi}, max SM clock {sm_clock_mhz():.0f} MHz | torch.cuda: "
          f"{torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernel build {build_s:.2f} s "
          f"{took}", flush=True)

    rows = kernel_phase()
    ragged_rows = ragged_phase()
    bwd_rows = bwd_kernel_phase()
    dw_rows = dw_kernel_phase()
    dw_ragged_rows = dw_ragged_phase()
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
    # after training: ensemble and predict (phases 15, 16), Grad-CAM and capture (17)
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=4, n_valid=ENS_VALID, image_size=IMAGE,
                               views_per_study=2)
        ensemble = ensemble_phase(d, smi)
        predict = predict_phase(d, ensemble.pop("members"), smi)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        make_synthetic_dataset(d, n_train=4, n_valid=VIS_VALID, image_size=IMAGE)
        gradcam = {
            "aadensenet121": gradcam_phase(d, smi, "aadensenet121", IMAGE, {NAME: 3},
                                           {"attn_impl": "einsum"}),
            f"{AA_RES} hil": gradcam_phase(d, smi, AA_RES, IMAGE, {HIL_FWD: N_AA},
                                           {"attn_impl": "einsum"}, layout="hil",
                                           calibrate=True, residual_gamma=AA_RESIDUAL_GAMMA),
            EFF: gradcam_phase(d, smi, EFF, EFF_IMAGE, {DW_FWD: DW_LAYERS},
                               {"dw_impl": "library"}, calibrate=True),
        }
    torch.cuda.empty_cache()
    multiprocess = {"world1_nccl": nccl_world1_phase(smi, train["ms_per_step"])}
    multiprocess.update(ddp_phase(smi))
    bench = bench_phase(smi)  # phase 19
    torch.cuda.empty_cache()
    inputs = input_phase(smi, train["ms_per_step"])  # phase 20
    torch.cuda.empty_cache()
    paths = {"serve aadensenet121": serve["counts"], "train aadensenet121": train["counts"],
             f"serve {EFF}": eff_serve["counts"], f"train {EFF}": eff_train["counts"],
             f"serve {AA_RES} hil": aa_serve["hil"]["counts"],
             f"serve {AA_RES} bn": aa_serve["bn"]["counts"],
             f"train {AA_RES} hil": aa_train["counts"],
             f"train {AA_RES} bn": aa_train["also"]["counts"],
             "ensemble aadensenet121": ensemble["counts"],
             "ensemble aadensenet121 chunk 1": ensemble["counts_chunk1"],
             **{f"predict aadensenet121 {k}": c for k, c in predict["counts"].items()},
             **{f"gradcam {k}": g["counts"] for k, g in gradcam.items()},
             "train aadensenet121 --multihost world 1 nccl":
                 multiprocess["world1_nccl"]["counts"],
             **multiprocess["counts"],
             **{f"bench {k}": r["counts"] for k, r in bench["runs"].items()},
             **{f"train aadensenet121 {k}": inputs[k]["counts"]
                for k in ("a_packed", "b_packed_device_aug", "c_packed_profile")}}

    def launches(name):  # each path's counts, reset just before it and read just after
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]  # the served dtype
    train_rows = [r for r in bwd_rows if r["dtype"] == "bfloat16"]  # the trained dtype

    def per_step(key):  # one train step launches each pass once per geometry
        return sum(r[key] for r in train_rows)

    def per_aa_bn(key):  # the same passes over aaresnet152's 47 AA convs (bn layout)
        return sum(r["layers"] * r[key] for r in train_rows)

    def bwd_entry(name, key, replaces_note):
        aa_bound = bound_sum((r["layers"], r[key]) for r in train_rows)
        return {
            "name": name, "route": "cuda",
            "source": "chexpert_tpu_torch/csrc/rel_attention_bwd.cu",
            "replaces": "chexpert_tpu/ops/pallas_attention.py:277",
            **launches(name),
            "max_abs_err": max(max(r["abs_err"].values()) for r in train_rows),
            "max_rel_err": max(max(r["rel_err"].values()) for r in train_rows),
            # device time (CUDA graph replay); events around the eager calls as host_ms
            "ms": per_step(f"{key}_ms"), "plain_ms": per_step(f"{key}_plain_ms"),
            **bound_sum((1, r[key]) for r in train_rows),
            "library_ms": per_step("library_ms"),
            "library_is": "backward of F.scaled_dot_product_attention w.r.t. q, k, v and a "
                          "materialized bias, device time (the profiler's sum over the "
                          "kernels of eager calls): the whole of B2, both passes",
            "host_ms": per_step(f"{key}_host_ms"),
            "library_host_ms": per_step("library_host_ms"),
            "per": f"aadensenet121 train step (bn {B_TRAIN * NH}, three geometries, bf16)",
            # the same pass over aaresnet152's AA convs (8 / 36 / 3 of the geometries)
            f"{AA_RES}_step": {
                "launches": N_AA, "ms": per_aa_bn(f"{key}_ms"),
                "bound_ms": aa_bound["bound_ms"], "bound_by": aa_bound["bound_by"],
                "library_ms": per_aa_bn("library_ms"),
                "library_host_ms": per_aa_bn("library_host_ms"),
                "whole_b2_ms": per_aa_bn("dkdv_ms") + per_aa_bn("dq_ms"),
                "whole_b2_bound_ms": bound_sum((r["layers"], r["b2"])
                                               for r in train_rows)["bound_ms"]},
            "pass": replaces_note, "card": smi,
        }

    dw_main = [r for r in dw_rows if r["dtype"] == "bfloat16"]  # served and trained dtype

    def per_layers(call, key):  # the 28 layers launch each geometry `layers` times
        return sum(r["layers"] * r[call][key] for r in dw_main)

    def dw_entry(name, call, source, replaces, errs, per, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **launches(name),
            "max_abs_err": max(r[call][e] for r in dw_main for e in errs[0]),
            "max_rel_err": max(r[call][e] for r in dw_main for e in errs[1]),
            # device time (CUDA graph replay); the eager calls' time beside it
            "ms": per_layers(call, "ms"), "plain_ms": per_layers(call, "plain_ms"),
            **bound_sum((r["layers"], r[call]) for r in dw_main),
            "library_ms": per_layers(call, "library_ms"),
            "host_ms": per_layers(call, "host_ms"),
            "library_host_ms": per_layers(call, "library_host_ms"),
            "per": per, **extra, "card": smi,
        }

    hil_main = [r for r in hil_rows if r["dtype"] == "bfloat16"]  # served and trained dtype

    def per_aa(call, key):  # the 47 AA convs launch each geometry `layers` times
        return sum(r["layers"] * r[call][key] for r in hil_main)

    def aa_bound(call):  # the bound of a call over the 47 AA convs
        return bound_sum((r["layers"], r[call]) for r in hil_main)

    def hil_entry(name, call, source, replaces, max_abs_err, max_rel_err, per, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **launches(name), "max_abs_err": max_abs_err,
            **({} if max_rel_err is None else {"max_rel_err": max_rel_err}),
            # device time (CUDA graph replay)
            "ms": per_aa(call, "ms"), "plain_ms": per_aa(call, "plain_ms"),
            **aa_bound(call),
            "per": per, **extra, "card": smi,
        }

    def bn_layout_ms(key):  # B1 / B2 over the same 47 layers, device time
        return sum(r["layers"] * r["bn_layout"][key] for r in hil_main)

    # B1 per aaresnet152 forward under bn (its 47 AA convs), served and trained batch
    b1_aaresnet152 = {}
    for batch in (B, B_TRAIN):
        b1_b = bound_sum((r["layers"], r["bn_layout"][f"b1_bound_batch{batch}"])
                         for r in hil_main)
        b1_aaresnet152[f"batch{batch}"] = {
            "launches": N_AA, "ms": bn_layout_ms(f"b1_ms_batch{batch}"),
            "bound_ms": b1_b["bound_ms"], "bound_by": b1_b["bound_by"],
            "library_ms": bn_layout_ms(f"b1_library_ms_batch{batch}")}

    hil_bwd_abs = max(max(r["bwd16"]["abs_err"].values()) for r in hil_main)
    hil_bwd_rel = max(max(r["bwd16"]["rel_err"].values()) for r in hil_main)
    hil_bwd_library = {
        "library_ms": per_aa("bwd16", "library_ms"),
        "library_host_ms": per_aa("bwd16", "library_host_ms"),
        "library_is": "backward of F.scaled_dot_product_attention w.r.t. P0 (through the "
                      "head-split and head-merge copies) and a materialized bias, device time "
                      "(the profiler's sum over the kernels of eager calls; library_host_ms: "
                      "events around them): the whole of B6, all three passes",
        "whole_b6_ms": per_aa("bwd16", "ms"), "whole_b6_host_ms": per_aa("bwd16", "host_ms"),
        "b2_same_layers_ms": bn_layout_ms("b2_dkdv_ms") + bn_layout_ms("b2_dq_ms")}
    hil_per_step = (f"{AA_RES} train step (batch {B_TRAIN}, {N_AA} AA convs: 8 at 40x40, 36 at "
                    "20x20, 3 at 10x10; bf16)")
    hil_bwd_src = "chexpert_tpu_torch/csrc/hil_attention_bwd.cu"
    hil_bwd_replaces = "chexpert_tpu/ops/pallas_attention.py:853"

    # phase 19's geometries (bf16, batch 256): per geometry the kernel's device
    # time beside its plain version, its bound and the library call, and the
    # sum over WideResNet-28-10's AA convs (one forward, or one step's pass)
    wrn_aa = bench["geometries"][" ".join(BENCH_WRN)]["aa"]
    bench_attn = [r for r in bench["attention_rows"] if r["dtype"] == "bfloat16"]
    bench_dw = [r for r in bench["depthwise_rows"] if r["dtype"] == "bfloat16"]

    def whole(r, part, sub):  # a backward pass's row: the passes summed, the whole's bound
        if sub is None:
            return {}
        w = r[part]["whole"]
        return {"whole_ms": w["ms"], "whole_bound_ms": w["bound_ms"],
                "whole_bound_by": w["bound_by"]}

    def bench_geometries(part, sub=None, plain=None, library=None, library_is=None):
        rows = []
        for r in bench_attn:
            t = r[part] if sub is None else r[part][sub]
            rows.append({"geometry": r["geometry"], "dvh": r["dvh"], "bn": r["bn"],
                         "ms": t["ms"], "plain_ms": t.get("plain_ms", plain and r[plain[0]]
                                                         [plain[1]]),
                         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                         "library_ms": (t.get("library_ms") if library is None
                                        else r[library[0]][library[1]]), **whole(r, part, sub)})
        ms = {(r["H"], r["W"], r["dvh"], r["dkh"]): row["ms"] for r, row in zip(bench_attn, rows)}
        return {"batch": BENCH_BATCH, "calls": rows, "library_is": library_is,
                "wideresnet_28_10_ms": sum(ms[g] for g in wrn_aa),
                "wideresnet_28_10_launches": len(wrn_aa)}

    def bench_dw_geometries(call):
        return {"batch": BENCH_BATCH, "calls": [
            {"geometry": r["geometry"], "C": r["C"], "k": r["k"],
             **{k: r[call][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
            for r in bench_dw],
            "efficientnet_b0_ms": sum(
                next(r[call]["ms"] for r in bench_dw if (int(r["geometry"].split("x")[0]),
                                                         r["C"], r["k"]) == g)
                for g in bench["geometries"]["efficientnet b0"]["dw"])}

    sdpa_fwd = "F.scaled_dot_product_attention with the relative bias materialized, device time"
    sdpa_bwd = ("backward of F.scaled_dot_product_attention w.r.t. q, k, v and a materialized "
                "bias (the profiler's device time): the whole backward, every pass")
    bench_by_kernel = {
        NAME: bench_geometries("b1", library_is=sdpa_fwd),
        BWD_DKDV: bench_geometries("b2", "dkdv", library=("b2", "library_ms"),
                                   library_is=sdpa_bwd),
        BWD_DQ: bench_geometries("b2", "dq", library=("b2", "library_ms"), library_is=sdpa_bwd),
        HIL_FWD: bench_geometries("b5", library=("b1", "library_ms"),
                                  library_is=sdpa_fwd + " (head-major operands, no head-split "
                                                        "copies)"),
        **{p: bench_geometries("b6", key, plain=("b6", "plain_ms"),
                               library=("b2", "library_ms"),
                               library_is=sdpa_bwd + "; plain_ms: the whole plain backward")
           for p, key in ((HIL_DKDV, "dkdv"), (HIL_DQ, "dq"), (HIL_DREL, "drel"))},
        DW_FWD: bench_dw_geometries("fwd"),
        DW_BWD: bench_dw_geometries("bwd"),
    }

    # the head-width classes (batch 256 x WIDTH_NH heads): per (dkh, dvh) and
    # map the kernel's device ms in bf16 and f32 beside its bound at the real
    # widths, its plain version and the library call, and its errors
    widths = bench["width_rows"]

    def width_calls(part, sub=None, library=None, plain=None):
        calls = []
        for r in widths:
            t = r[part] if sub is None else r[part][sub]
            lib = t.get("library_ms") if library is None else r[library[0]][library[1]]
            err = r[part].get("abs_err") or r[part].get("rel_err")
            calls.append({"geometry": r["geometry"], "dkh": r["dkh"], "dvh": r["dvh"],
                          "bn": r["bn"], "width_class": r["width_class"], "chunks": r["chunks"],
                          "dtype": r["dtype"],
                          "tensor_cores": r["tensor_cores"], "ms": t["ms"],
                          "plain_ms": t.get("plain_ms", plain and r[plain[0]][plain[1]]),
                          "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                          "library_ms": lib, "max_err": max(err.values()),
                          "err_is": "abs" if "abs_err" in r[part] else "rel",
                          **whole(r, part, sub)})
        return {"batch": BENCH_BATCH, "heads": WIDTH_NH, "calls": calls}

    width_by_kernel = {
        NAME: width_calls("b1"),
        BWD_DKDV: width_calls("b2", "dkdv", library=("b2", "library_ms")),
        BWD_DQ: width_calls("b2", "dq", library=("b2", "library_ms")),
        HIL_FWD: width_calls("b5", library=("b1", "library_ms")),
        **{p: width_calls("b6", key, library=("b2", "library_ms"), plain=("b6", "plain_ms"))
           for p, key in ((HIL_DKDV, "dkdv"), (HIL_DQ, "dq"), (HIL_DREL, "drel"))},
    }

    record = {"kernels": [{
        "name": NAME,
        "route": "cuda",
        "source": "chexpert_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "chexpert_tpu/ops/pallas_attention.py:178",
        **launches(NAME),
        # bf16, at the served grid (bn 32) and the training grid (bn 128)
        "max_abs_err": max([max(r["max_abs_err_out"], r["max_abs_err_lse"]) for r in main_rows]
                           + [max(r["fwd_abs_err"].values()) for r in train_rows]),
        # one served forward launches each geometry once: times are per forward, device
        # time (CUDA-graph replay); the eager calls' time beside it
        "ms": sum(r["kernel_ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        **bound_sum((1, r) for r in main_rows),
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "library_is": "F.scaled_dot_product_attention with the relative bias materialized "
                      "beforehand, device time",
        "host_ms": sum(r["host_ms"] for r in main_rows),
        "library_host_ms": sum(r["library_host_ms"] for r in main_rows),
        "per": f"served aadensenet121 forward (bn {B * NH}, three geometries, bf16)",
        "train_forward_ms": per_step("fwd_ms"),
        f"{AA_RES}_forward": b1_aaresnet152,
        "ragged_calls": ragged_rows,
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
                 train_forward_library_ms=per_layers(f"fwd{B_TRAIN}", "library_ms"),
                 ragged_calls=dw_ragged_rows),
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
                  train_forward_bound_ms=aa_bound(f"fwd{B_TRAIN}")["bound_ms"],
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
        **bound_sum((1, r["b2"]) for r in train_rows),
        "ms": per_step("dkdv_ms") + per_step("dq_ms"), "calls": bwd_rows},
        "depthwise_calls": dw_rows,
        "serve": serve, "train": {**train, "card": smi},
        f"serve {EFF}": eff_serve, f"train {EFF}": {**eff_train, "card": smi},
        "b6_whole": {**aa_bound("bwd16"), "ms": per_aa("bwd16", "ms")},
        "sm_clock_max_mhz": sm_clock_mhz(),
        "hil_calls": hil_rows,
        f"serve {AA_RES}": aa_serve, f"train {AA_RES}": {**aa_train, "card": smi},
        "ensemble": ensemble, "predict": predict, "gradcam": gradcam,
        "multiprocess": multiprocess, "bench": bench, "input_path": inputs}
    for entry in record["kernels"]:
        entry["bench_geometries"] = bench_by_kernel[entry["name"]]
        if entry["name"] in width_by_kernel:
            entry["width_rows"] = width_by_kernel[entry["name"]]
    record["kernel_builds_s"] = took
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(ddp_worker(sys.argv[2:]) if sys.argv[1:2] == [WORKER_FLAG] else main())
