"""The port's depthwise convolution (ops/depthwise.py) against the JAX
package's ``depthwise_conv2d``, on the CPU.

The JAX side runs with ``CHEXPERT_DW=pallas`` (set through monkeypatch), so
its stride-1 layers go through the Pallas kernels B3 / B4 in interpret mode;
the port's wrappers run their plain versions (CPU tensors), through the
``DepthwiseConv2d`` autograd function. Inputs and cotangents are numpy draws
from a seed, NHWC for JAX and transposed to NCHW for the port.

Tolerances: f32, max |port - JAX| <= 1e-5 * max(1, max |JAX|) per output
(the same f32 sums in another order; dw sums up to 1152 terms). bf16 at the
tolerances of tests/test_depthwise.py: both sides round their f32 sums to
bf16, so y and dx may differ by one bf16 ulp (2^-8 relative); dw is f32 on
both sides and rounded through bf16 by the same cast chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.ops.pallas_depthwise import _xla_depthwise
from chexpert_tpu.ops.pallas_depthwise import depthwise_conv2d as jax_depthwise
from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.models.common import same_padding
from chexpert_tpu_torch.ops.depthwise import (
    DepthwiseConv2d,
    depthwise_bwd,
    depthwise_bwd_plain,
    depthwise_conv2d,
    depthwise_fwd,
    depthwise_fwd_plain,
)

GEOMETRIES = [  # (B, H, W, C, k), those of tests/test_depthwise.py
    pytest.param(2, 24, 24, 48, 3, id="lane_padded_c48"),
    pytest.param(2, 12, 12, 144, 5, id="c_tail_k5"),
    pytest.param(1, 10, 10, 130, 3, id="odd_hw_c130"),
    pytest.param(2, 7, 9, 64, 3, id="tiny_rect"),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def pallas_mode(monkeypatch):
    monkeypatch.setenv("CHEXPERT_DW", "pallas")


def _inputs(B, H, W, C, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(k, k, 1, C) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    return x, w, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _w_port(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _np(t):
    return t.detach().float().numpy()


def _jax_nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _close_f32(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def _jax_vjp(x, w, g, jdt, stride=1):
    y, vjp = jax.vjp(lambda a, b: jax_depthwise(a, b, stride),
                     jnp.asarray(x, jdt), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g, jdt))
    return _jax_nchw(y), _jax_nchw(dx), np.asarray(dw).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C,k", GEOMETRIES)
def test_depthwise_matches_jax_pallas(pallas_mode, B, H, W, C, k, dtype):
    """Forward and both gradients of the port's DepthwiseConv2d (through
    depthwise_conv2d) against jax.vjp of the JAX function on its Pallas path."""
    jdt, tdt = DTYPES[dtype]
    x, w, g = _inputs(B, H, W, C, k)
    y_j, dx_j, dw_j = _jax_vjp(x, w, g, jdt)

    xt = _nchw(x).to(tdt).requires_grad_()
    wt = _w_port(w).requires_grad_()
    kernels.reset_launch_counts()
    y = depthwise_conv2d(xt, wt, 1)
    y.backward(_nchw(g).to(tdt))
    assert kernels.launch_counts() == {}  # CPU tensors: the plain versions
    assert y.dtype == xt.grad.dtype == tdt and wt.grad.dtype == torch.float32
    if dtype == "f32":
        for got, want in ((y, y_j), (xt.grad, dx_j), (wt.grad, dw_j)):
            _close_f32(_np(got), want)
    else:
        np.testing.assert_allclose(_np(y), y_j, atol=2e-3, rtol=2e-2)
        np.testing.assert_allclose(_np(xt.grad), dx_j, atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(_np(wt.grad), dw_j, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("B,H,W,C,k", GEOMETRIES[:2])
def test_plain_versions_match_jax_pallas(pallas_mode, B, H, W, C, k):
    """depthwise_fwd_plain / depthwise_bwd_plain and the wrappers on CPU
    tensors, f32, against the JAX Pallas path; dw of B4 unrounded."""
    x, w, g = _inputs(B, H, W, C, k, seed=1)
    y_j, dx_j, dw_j = _jax_vjp(x, w, g, jnp.float32)
    xt, wt, gt = _nchw(x), _w_port(w), _nchw(g)
    for fwd in (depthwise_fwd_plain, depthwise_fwd):
        _close_f32(_np(fwd(xt, wt)), y_j)
    for bwd in (depthwise_bwd_plain, depthwise_bwd):
        dx, dw = bwd(xt, wt, gt)
        assert dw.shape == (C, 1, k, k)
        _close_f32(_np(dx), dx_j)
        _close_f32(_np(dw), dw_j)


def test_autocast_computes_in_bf16(pallas_mode):
    """Under CPU autocast the f32 input is cast to bf16 before the Function
    (autocast does not reach inside it): the JAX function on bf16 x."""
    x, w, g = _inputs(2, 12, 12, 48, 3, seed=2)
    y_j, _, _ = _jax_vjp(x, w, g, jnp.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = depthwise_conv2d(_nchw(x), _w_port(w), 1)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), y_j, atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("H,W,k", [(16, 16, 3), (15, 15, 3), (24, 24, 5), (13, 11, 5)])
def test_stride2_matches_xla(H, W, k):
    """Stride 2 takes the library route with TF-SAME padding (asymmetric on
    even sizes): the JAX _xla_depthwise, f32, at even and odd sizes."""
    x, w, g = _inputs(2, H, W, 32, k, seed=3)
    want = _jax_nchw(_xla_depthwise(jnp.asarray(x), jnp.asarray(w), 2, k))
    xt, wt = _nchw(x).requires_grad_(), _w_port(w).requires_grad_()
    y = depthwise_conv2d(xt, wt, 2)
    assert y.shape == want.shape
    _close_f32(_np(y), want)
    _, vjp = jax.vjp(lambda a, b: _xla_depthwise(a, b, 2, k), jnp.asarray(x), jnp.asarray(w))
    gy = np.random.RandomState(4).randn(*want.shape).astype(np.float32)
    dx_j, dw_j = vjp(jnp.asarray(gy.transpose(0, 2, 3, 1)))
    y.backward(torch.from_numpy(gy))
    _close_f32(_np(xt.grad), _jax_nchw(dx_j))
    _close_f32(_np(wt.grad), np.asarray(dw_j).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("n,k,s", [(380, 3, 2), (190, 3, 2), (95, 5, 2), (48, 3, 2),
                                   (24, 5, 2), (57, 3, 2), (12, 5, 1), (7, 3, 1), (5, 1, 2)])
def test_same_padding_matches_lax(n, k, s):
    """The port's TF-SAME rule gives lax's 'SAME' padding, e.g. (0, 1) for the
    stem at 380 and (1, 2) for the 24 -> 12 k5 layer."""
    assert same_padding(n, k, s) == tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def test_library_route_equals_kernel_route():
    x, w, _ = _inputs(2, 11, 13, 40, 5, seed=5)
    xt, wt = _nchw(x), _w_port(w)
    _close_f32(_np(depthwise_conv2d(xt, wt, 1, impl="library")),
               _np(depthwise_conv2d(xt, wt, 1, impl="kernel")))


def test_guards():
    """No path hides the kernel: a tensor that is neither on the CPU nor on a
    CUDA device raises instead of running the plain version; malformed
    operands and unknown routes raise."""
    x = torch.zeros(1, 4, 6, 6, device="meta")
    w = torch.zeros(4, 1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        depthwise_fwd(x, w)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        depthwise_bwd(x, w, x)
    xc = torch.zeros(1, 4, 6, 6)
    with pytest.raises(ValueError, match="odd-k"):
        depthwise_fwd(xc, torch.zeros(4, 1, 2, 2))
    with pytest.raises(ValueError, match="dw_impl"):
        depthwise_conv2d(xc, torch.zeros(4, 1, 3, 3), 1, impl="cudnn")
    with pytest.raises(ValueError, match="depthwise kernel"):
        depthwise_conv2d(xc, torch.zeros(3, 1, 3, 3))
    assert DepthwiseConv2d.apply(xc, torch.zeros(4, 1, 3, 3)).shape == xc.shape
