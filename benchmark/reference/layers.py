"""Layers of the reference models, written out with plain torch operations.

A model's parameters are one flat dict, name -> tensor, under the names of
the published checkpoints (torchvision's module names). ``precision`` says
how the operands of every product (convolution, linear, attention) are
rounded before it runs, the accumulation staying float32:

  * ``"f32"``: not at all (the reference);
  * ``"bf16"``: to bfloat16 (what the program's autocast does);
  * ``"fp8"``: to float8 e4m3 with one scale per tensor, its largest value
    mapped to 448, and the gradients of the products' outputs to float8
    e5m2 likewise (FP8 training's recipe, arXiv:2209.05433; the control:
    the precision below the configuration's).

Each product's output is stored in the same precision as its operands
(bfloat16, as autocast stores it, or float8 e4m3), and the gradient of
that output is rounded in the backward (bfloat16, or float8 e5m2). The
roundings pass the gradient straight through, so the backward of a
rounded product is the product's backward at the rounded operands.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16", "fp8")
FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _to(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """x rounded to ``dtype``, scaled per tensor so that its largest
    magnitude maps to ``largest`` (float8), or as it is (bfloat16)."""
    if dtype == torch.bfloat16:
        return x.to(dtype).float()
    scale = largest / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


FORWARD = {"bf16": (torch.bfloat16, 0.0), "fp8": (torch.float8_e4m3fn, FP8_MAX)}
BACKWARD = {"bf16": (torch.bfloat16, 0.0), "fp8": (torch.float8_e5m2, 57344.0)}


class _RoundOut(torch.autograd.Function):
    """A product's output rounded in the forward; the backward rounds the
    incoming gradient and passes it straight through."""

    @staticmethod
    def forward(ctx, y, precision):
        ctx.precision = precision
        return _to(y, *FORWARD[precision])

    @staticmethod
    def backward(ctx, g):
        return _to(g, *BACKWARD[ctx.precision]), None


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a product, rounded: bfloat16, or float8 e4m3 (the
    forward format of FP8 training, arXiv:2209.05433); the gradient passes
    through."""
    if precision == "f32":
        return x
    if precision not in FORWARD:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    return x + (_to(x, *FORWARD[precision]) - x).detach()


def product_out(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's output, stored as its operands are (bfloat16 as
    autocast stores it, or float8 e4m3 with one scale per tensor), its
    gradient rounded in the backward (bfloat16, or float8 e5m2)."""
    if precision == "f32":
        return y
    return _RoundOut.apply(y, precision)


def conv2d(x, w, stride=1, padding=0, precision="f32"):
    return product_out(F.conv2d(rounded(x, precision), rounded(w, precision), stride=stride,
                                padding=padding), precision)


def linear(x, w, b, precision="f32"):
    return product_out(rounded(x, precision) @ rounded(w, precision).t(), precision) + b


def batch_norm(x, P, name, train: bool, eps: float = 1e-5):
    """BatchNorm2d: batch statistics (biased variance) in training, the
    running ones otherwise; the running statistics are not updated."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + eps)
    return y * P[name + ".weight"][:, None, None] + P[name + ".bias"][:, None, None]


def instance_norm(x, eps: float = 1e-5):
    """Affine-free InstanceNorm2d, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def relative_index(n_rows: int, n_cols: int, device):
    """(HW, HW) indices into the (dkh, 2W-1) and (dkh, 2H-1) embeddings:
    for query i = (ri, ci) and key j = (rj, cj), cj - ci + W - 1 and
    rj - ri + H - 1."""
    r = torch.arange(n_rows, device=device).repeat_interleave(n_cols)
    c = torch.arange(n_cols, device=device).repeat(n_rows)
    return (c[None, :] - c[:, None] + n_cols - 1, r[None, :] - r[:, None] + n_rows - 1)


def rel_attention(q, k, v, rel_w, rel_h, H: int, W: int, precision="f32"):
    """Multi-head self-attention over the H*W positions with 2-D relative
    position logits (Bello et al., arXiv:1904.09925, eq. 3):
    logit(i, j) = q_i . k_j + q_i . r^W_{cj-ci} + q_i . r^H_{rj-ri}.
    q (pre-scaled by dkh^-0.5), k: (B, nh, HW, dkh); v: (B, nh, HW, dvh);
    rel_w (dkh, 2W-1), rel_h (dkh, 2H-1). Returns (B, nh, HW, dvh)."""
    q, k, v = (rounded(t, precision) for t in (q, k, v))
    logits = product_out(q @ k.transpose(-1, -2), precision)
    if rel_w is not None:
        iw, ih = relative_index(H, W, q.device)
        B, nh, hw, _ = q.shape
        qw = product_out(q @ rounded(rel_w, precision), precision)  # (B, nh, HW, 2W-1)
        qh = product_out(q @ rounded(rel_h, precision), precision)  # (B, nh, HW, 2H-1)
        logits = (logits + qw.gather(-1, iw.expand(B, nh, hw, hw))
                  + qh.gather(-1, ih.expand(B, nh, hw, hw)))
    p = torch.softmax(logits, dim=-1)
    return product_out(rounded(p, precision) @ v, precision)


def aa_conv(x, P, name, cfg_layer, precision="f32"):
    """Attention-augmented convolution (arXiv:1904.09925): the concatenation
    of a k x k convolution with out - dv filters and the projected attention
    over the (strided) map, channels [conv ; attention]. cfg_layer: dict of
    dk, dv, nh, stride, kernel, relative."""
    dk, dv, nh, s = cfg_layer["dk"], cfg_layer["dv"], cfg_layer["nh"], cfg_layer["stride"]
    dkh, dvh = dk // nh, dv // nh
    qkv = conv2d(x, P[name + ".in_proj_qkv.weight"], stride=s, precision=precision)
    B, _, H, W = qkv.shape

    def heads(t, dh):  # channel h * dh + d -> (B, nh, HW, dh)
        return t.reshape(B, nh, dh, H * W).transpose(2, 3)

    q, k, v = torch.split(qkv, [dk, dk, dv], dim=1)
    rel_w = P.get(name + ".key_rel_w") if cfg_layer["relative"] else None
    rel_h = P.get(name + ".key_rel_h") if cfg_layer["relative"] else None
    att = rel_attention(heads(q, dkh) * dkh ** -0.5, heads(k, dkh), heads(v, dvh),
                        rel_w, rel_h, H, W, precision)
    att = att.transpose(2, 3).reshape(B, dv, H, W)
    att = conv2d(att, P[name + ".out_proj.weight"], precision=precision)
    kernel = cfg_layer["kernel"]
    conv_name = name + ".conv.weight"
    if conv_name not in P:
        return att
    y = conv2d(x, P[conv_name], stride=s, padding=kernel // 2, precision=precision)
    return torch.cat([y, att], dim=1)


def attn_dims(k: float, v: float, nh: int, channels: int, min_dk_per_head: int):
    """dk = max(min_dk_per_head * nh, floor(k * channels / nh) * nh),
    dv = floor(v * channels / nh) * nh (the reference repository's rule)."""
    dk = max(min_dk_per_head * nh, int(math.floor(k * channels / nh)) * nh)
    return dk, int(math.floor(v * channels / nh)) * nh


def aa_shapes(name, cin, cout, kernel, layer):
    """Parameter shapes and init kinds of an AA conv."""
    dk, dv, nh = layer["dk"], layer["dv"], layer["nh"]
    H, W = layer["map"]
    out = {name + ".in_proj_qkv.weight": ((2 * dk + dv, cin, 1, 1), "conv")}
    if layer["relative"]:
        out[name + ".key_rel_h"] = ((dk // nh, 2 * H - 1), "rel")
        out[name + ".key_rel_w"] = ((dk // nh, 2 * W - 1), "rel")
    out[name + ".out_proj.weight"] = ((dv, dv, 1, 1), "conv")
    if cout > dv:
        out[name + ".conv.weight"] = ((cout - dv, cin, kernel, kernel), "conv")
    return out


def bn_shapes(name, c):
    return {name + ".weight": ((c,), "ones"), name + ".bias": ((c,), "zeros"),
            name + ".running_mean": ((c,), "zeros"), name + ".running_var": ((c,), "ones"),
            name + ".num_batches_tracked": ((), "count")}
