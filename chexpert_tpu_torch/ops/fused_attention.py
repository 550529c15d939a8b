"""Fused relative-position attention forward: wrapper of the hand-written
CUDA kernel ``csrc/rel_attention_fwd.cu`` and its plain PyTorch version.

Port of the TPU kernel chexpert_tpu/ops/pallas_attention.py::_fwd_kernel
(host side ``_flash_forward``). ``rel_attention_fwd`` takes the packed
query operand of ``ops.attention.pack_query`` flattened to (B*nh, HW, L):

  * a CUDA tensor launches the kernel (or raises: there is no fallback);
  * a CPU tensor runs ``rel_attention_fwd_plain``, the same function in
    plain torch ops. Nothing on the card path calls it; ``chip_smoke.py``
    holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from chexpert_tpu_torch import kernels

NAME = "rel_attention_fwd"
SUPPORTED_DKH = (20,)  # head widths the kernel is instantiated for
MAX_DVH = 8
_ENTRY = {torch.float32: "rel_attention_fwd_f32", torch.bfloat16: "rel_attention_fwd_bf16"}


def key_positions(hw: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col, row) image coordinates of each key token, row-major."""
    j = torch.arange(hw, device=device)
    return j % W, j // W


def rel_attention_fwd_plain(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            H: int, W: int, dkh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense softmax in f32: S = q.k^T + RW[:, col(j)] + RH[:, row(j)].
    Returns (out in v's dtype, lse f32)."""
    hw = H * W
    col, row = key_positions(hw, W, qr.device)
    qf = qr.float()
    with torch.autocast(qr.device.type, enabled=False):
        s = (torch.bmm(qf[..., :dkh], k.float().transpose(1, 2))
             + qf[..., dkh:dkh + W][..., col] + qf[..., dkh + W:][..., row])
        lse = torch.logsumexp(s, dim=-1)
        out = torch.bmm(torch.exp(s - lse[..., None]), v.float())
    return out.to(v.dtype), lse


def _check(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int, W: int, dkh: int):
    if qr.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("qr, k, v must be (B*nh, HW, features)")
    bn, hw, L = qr.shape
    if hw != H * W or L != dkh + W + H:
        raise ValueError(f"qr {tuple(qr.shape)} does not match H={H} W={W} dkh={dkh}")
    if k.shape != (bn, hw, dkh) or v.shape[:2] != (bn, hw):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match qr {tuple(qr.shape)}")
    if not (qr.device == k.device == v.device):
        raise ValueError("qr, k, v must be on one device")


def rel_attention_fwd(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      H: int, W: int, dkh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """qr (bn, HW, dkh+W+H) packed [q ; RW ; RH], k (bn, HW, dkh),
    v (bn, HW, dvh) -> (out (bn, HW, dvh) in the operand dtype, lse (bn, HW) f32)."""
    _check(qr, k, v, H, W, dkh)
    if qr.device.type == "cpu":
        return rel_attention_fwd_plain(qr, k, v, H, W, dkh)
    if qr.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {qr.device}")
    bn, hw, _ = qr.shape
    dvh = v.shape[-1]
    if dkh not in SUPPORTED_DKH or not 1 <= dvh <= MAX_DVH:
        raise ValueError(f"{NAME}: kernel takes dkh in {SUPPORTED_DKH} and dvh in "
                         f"1..{MAX_DVH}, got dkh={dkh} dvh={dvh}")
    if qr.dtype not in _ENTRY or not (qr.dtype == k.dtype == v.dtype):
        raise ValueError(f"{NAME}: operands must share one dtype of "
                         f"{list(_ENTRY)}, got {qr.dtype}, {k.dtype}, {v.dtype}")
    if not (qr.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{NAME}: operands must be contiguous")
    if bn > 65535:
        raise ValueError(f"{NAME}: bn={bn} exceeds the grid's y limit")
    lib = kernels.load(NAME)
    fn = getattr(lib, _ENTRY[qr.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((bn, hw, dvh), dtype=v.dtype, device=qr.device)
    lse = torch.empty((bn, hw), dtype=torch.float32, device=qr.device)
    with torch.cuda.device(qr.device):
        stream = torch.cuda.current_stream(qr.device).cuda_stream
        err = fn(qr.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 bn, hw, H, W, dkh, dvh, stream)
    kernels.check(err, NAME)
    kernels.count_launch(NAME)
    return out, lse
