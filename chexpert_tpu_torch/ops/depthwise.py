"""Depthwise convolution: wrappers of the hand-written CUDA kernels
``csrc/depthwise_fwd.cu`` (B3) and ``csrc/depthwise_bwd.cu`` (B4), their
plain PyTorch versions, the autograd function that joins them, and
``depthwise_conv2d``, the counterpart of the JAX
chexpert_tpu/ops/pallas_depthwise.py::depthwise_conv2d.

Ports of the TPU kernels ``_fwd_kernel`` (host side ``_pallas_fwd``) and
``_bwd_kernel`` (host side ``_pallas_bwd``), in the port's NCHW layout:
x (B, C, H, W), w (C, 1, k, k) (the JAX HWIO (k, k, 1, C) transposed).

  * a CUDA tensor launches the kernel (or raises: there is no fallback);
  * a CPU tensor runs the ``*_plain`` version, the same function in plain
    torch ops. Nothing on the card path calls it; ``chip_smoke.py`` holds the
    kernels against it on the card.

``depthwise_conv2d(x, w, stride, impl)`` routes as the JAX function does
under ``CHEXPERT_DW=pallas``: stride 1 with an odd k goes through
``DepthwiseConv2d`` (forward B3, backward B4); stride 2, an even k, or
``impl="library"`` (the counterpart of ``CHEXPERT_DW=xla``) is a TF-SAME
``F.pad`` plus ``F.conv2d(groups=C)``. The kernels take every stride-1 odd-k
geometry with k <= 9: their tile plan (``csrc/depthwise_common.cuh``) sizes
every tile to its shared-memory budget, so the host has no feasibility check
(the TPU's ``_feasible`` / ``_pick_th`` VMEM budget has no meaning here).

Numerics follow the JAX function: the compute dtype is the autocast dtype
when autocast is on, else x's dtype; the weight is rounded to it before the
f32 accumulation (``w.astype(x.dtype).astype(f32)``); y and dx are in the
compute dtype; dw is summed in f32 and, as JAX's cast chain does, rounded
through the compute dtype on its way back to the f32 parameter.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from chexpert_tpu_torch import kernels

FWD = "depthwise_fwd"
BWD = "depthwise_bwd"
IMPLS = ("kernel", "library")
KERNEL_SIZES = (1, 3, 5, 7, 9)  # the kernels' instantiations
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _shifted(xp: torch.Tensor, dy: int, dx: int, H: int, W: int) -> torch.Tensor:
    return xp[..., dy:dy + H, dx:dx + W]


def depthwise_fwd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B3 in plain ops: k*k shifted multiply-adds of the zero-padded x in f32,
    w rounded to x's dtype first; y in x's dtype."""
    k, (H, W) = w.shape[-1], x.shape[-2:]
    p = k // 2
    with torch.autocast(x.device.type, enabled=False):
        xp = F.pad(x.float(), (p, p, p, p))
        wf = w.to(x.dtype).float()
        y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for dy in range(k):
            for dx in range(k):
                y += wf[:, 0, dy, dx].view(1, -1, 1, 1) * _shifted(xp, dy, dx, H, W)
    return y.to(x.dtype)


def depthwise_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 in plain ops: dx, the flipped-kernel conv of the zero-padded g, in
    g's dtype; dw (C, 1, k, k) = sum over (b, i, j) of shifted x times g, f32."""
    k, (H, W) = w.shape[-1], x.shape[-2:]
    p = k // 2
    with torch.autocast(x.device.type, enabled=False):
        xp = F.pad(x.float(), (p, p, p, p))
        g32 = g.float()
        gp = F.pad(g32, (p, p, p, p))
        wf = w.to(x.dtype).float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty((x.shape[1], k, k), dtype=torch.float32, device=x.device)
        for dy in range(k):
            for dxx in range(k):
                dx += (wf[:, 0, k - 1 - dy, k - 1 - dxx].view(1, -1, 1, 1)
                       * _shifted(gp, dy, dxx, H, W))
                dw[:, dy, dxx] = (_shifted(xp, dy, dxx, H, W) * g32).sum((0, 2, 3))
    return dx.to(g.dtype), dw.view(-1, 1, k, k)


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    """The kernel size k of a depthwise weight (C, 1, k, k) matching x."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W) and w (C, 1, k, k), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    k = w.shape[-1]
    if w.shape != (x.shape[1], 1, k, k) or k % 2 == 0:
        raise ValueError(f"w {tuple(w.shape)} is not an odd-k depthwise kernel for "
                         f"x {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    return k


def _entry(name: str, x: torch.Tensor, k: int):
    """Validate what the kernel takes and return its ctypes entry."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_SUFFIX:
        raise ValueError(f"{name}: x dtype must be one of {list(_DTYPE_SUFFIX)}, got {x.dtype}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"{name}: the kernel is instantiated for k in {KERNEL_SIZES}, got {k}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (NCHW)")
    if x.shape[1] > 65535:
        raise ValueError(f"{name}: C={x.shape[1]} exceeds the grid's y limit")
    return getattr(kernels.load(name), f"{name}_{_DTYPE_SUFFIX[x.dtype]}")


def _n_part(B: int, C: int, H: int, W: int, k: int) -> int:
    """Rows of B4's dw partials: its blocks per channel group, as the CUDA
    source's tile plan computes them (``depthwise_bwd_n_part``)."""
    fn = kernels.load(BWD).depthwise_bwd_n_part
    if fn.argtypes is None:
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * 5
    n = fn(B, C, H, W, k)
    if n < 1:
        raise ValueError(f"{BWD}: the kernel does not take x of shape {(B, C, H, W)}")
    return n


def _f32(w: torch.Tensor) -> torch.Tensor:
    """w as the kernels read it: contiguous f32, (C, k*k) rows; they round it
    to the activation dtype themselves."""
    return w if w.dtype == torch.float32 and w.is_contiguous() else w.float().contiguous()


def depthwise_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B3: x (B, C, H, W) f32/bf16, w (C, 1, k, k) -> y in x's dtype (stride 1,
    SAME). Not differentiable on the card: use ``DepthwiseConv2d.apply``."""
    k = _check(x, w)
    if x.device.type == "cpu":
        return depthwise_fwd_plain(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(f"{FWD}: operands require grad but the raw kernel wrapper has no "
                           "backward; call DepthwiseConv2d.apply (forward B3, backward B4)")
    fn = _entry(FWD, x, k)
    B, C, H, W = x.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    w32 = _f32(w)  # held until the launch is enqueued
    kernels.launch(FWD, fn, [x.data_ptr(), w32.data_ptr(), y.data_ptr()],
                   [B, C, H, W, k], x.device)
    return y


def depthwise_bwd(x: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: (dx in g's dtype, dw (C, 1, k, k) f32) for y = depthwise_fwd(x, w)
    and its cotangent g. One kernel writes dx and a per-block f32 partial of
    dw; one torch sum over the partials follows (the JAX host side sums its
    per-batch partials in XLA)."""
    k = _check(x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return depthwise_bwd_plain(x, w, g)
    fn = _entry(BWD, x, k)
    if not g.is_contiguous():
        raise ValueError(f"{BWD}: g must be contiguous (NCHW)")
    B, C, H, W = x.shape
    n_part = _n_part(B, C, H, W, k)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    part = torch.empty((n_part, C, k * k), dtype=torch.float32, device=x.device)
    w32 = _f32(w)  # held until the launch is enqueued
    kernels.launch(BWD, fn, [x.data_ptr(), g.data_ptr(), w32.data_ptr(), dx.data_ptr(),
                             part.data_ptr()], [B, C, H, W, k, n_part], x.device)
    return dx, part.sum(0).view(C, 1, k, k)


class DepthwiseConv2d(torch.autograd.Function):
    """y = depthwise(x, w), stride 1, SAME, with forward B3 and backward B4
    (plain versions for CPU tensors). x is in the compute dtype; w is the f32
    parameter."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return depthwise_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dx, dw = depthwise_bwd(x, w, g.to(x.dtype).contiguous())
        # the forward read w rounded to x's dtype: its gradient comes back
        # through that rounding, as JAX's w.astype(x.dtype).astype(f32) chain
        return dx, dw.to(x.dtype).to(w.dtype)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The autocast dtype when autocast is on for x's device, else x's dtype."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     impl: str = "kernel") -> torch.Tensor:
    """TF-SAME depthwise conv of NCHW x with w (C, 1, k, k) in the compute
    dtype: the kernels (B3 / B4) for stride 1 and odd k when ``impl`` is
    "kernel", else the library grouped conv (the JAX ``_xla_depthwise``)."""
    if impl not in IMPLS:
        raise ValueError(f"dw_impl must be one of {IMPLS}, got {impl!r}")
    k = w.shape[-1]
    if w.dim() != 4 or w.shape != (x.shape[1], 1, k, k):
        raise ValueError(f"w {tuple(w.shape)} is not a depthwise kernel for x {tuple(x.shape)}")
    x = x.to(_compute_dtype(x))
    if impl == "library" or stride != 1 or k % 2 == 0:
        # imported here: the models package imports this module
        from chexpert_tpu_torch.models.common import pad_same

        return F.conv2d(pad_same(x, k, stride), w.to(x.dtype), stride=stride, groups=x.shape[1])
    return DepthwiseConv2d.apply(x.contiguous(), w)
