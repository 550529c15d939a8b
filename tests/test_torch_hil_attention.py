"""The port's heads-in-lanes attention (``ops/hil_attention.py``: the plain
versions of kernels B5 / B6, ``HilAttention``, ``AAConv2d(attn_layout="hil")``)
against the JAX package's, on the CPU, in float32.

The same numpy inputs go through both. JAX runs its Pallas HIL kernels in
interpret mode (``_hil_forward``, ``_hil_bwd_rule``, ``aa_attention_hil``, and
``AAConv2d`` under ``CHEXPERT_ATTN_LAYOUT=hil``), with the slot stride the
test names: its default 64 and ``tight``; the port takes the slot as an
argument. Tolerances: forward 1e-5 absolute on outputs of magnitude ~1 and
lse ~5 (the same f32 algorithm; JAX's online softmax and MXU-shaped dots sum
in another order); gradients 1e-5 relative to the largest entry of each
tensor; aadensenet-tiny logits 5e-4, the forward-parity bound of the other
model tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.attn import AAConv2d as JaxAAConv2d
from chexpert_tpu.ops import pallas_attention as jpa
from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.models import AAConv2d, build_model, state_dict_from_jax
from chexpert_tpu_torch.ops.attention import aa_attention_einsum
from chexpert_tpu_torch.ops.hil_attention import (
    BWD_PASSES,
    FWD,
    aa_attention_hil,
    hil_attention_bwd,
    hil_attention_bwd_plain,
    hil_attention_fwd,
    hil_attention_fwd_plain,
    hil_rel_operand,
    hil_slot,
)

ATOL = 1e-5
RTOL_GRAD = 1e-5  # of the largest |entry| of each gradient

# (B, nh, H, W, dkh, dvh, relative, tiles): the JAX HIL tests' geometries;
# tiles forces several query blocks / key chunks on the JAX side
GEOMETRIES = [
    pytest.param(2, 2, 5, 6, 8, 1, True, None, id="dvh1_padded_hw30"),
    pytest.param(1, 2, 4, 4, 8, 4, False, None, id="no_rel"),
    pytest.param(1, 2, 8, 8, 8, 4, True, "16,32", id="nq4_nk2"),
    pytest.param(1, 2, 7, 9, 8, 2, True, "16,16", id="padded_hw63_nq_nk4"),
    pytest.param(2, 8, 6, 6, 20, 1, True, None, id="aares_l2_like"),
]
SLOTS = ["64", "tight"]


def _mk(B, nh, H, W, dkh, dvh, relative, seed=7):
    rng = np.random.RandomState(seed)
    hw = H * W
    q5 = (rng.randn(B, hw, nh, dkh) * dkh ** -0.5).astype(np.float32)
    k5 = rng.randn(B, hw, nh, dkh).astype(np.float32)
    v5 = rng.randn(B, hw, nh, dvh).astype(np.float32)
    rw = (0.5 * rng.randn(dkh, 2 * W - 1)).astype(np.float32) if relative else None
    rh = (0.5 * rng.randn(dkh, 2 * H - 1)).astype(np.float32) if relative else None
    g = rng.randn(B, hw, nh, dvh).astype(np.float32)
    return q5, k5, v5, rw, rh, g


def _pack(q5, k5, v5, slot):
    B, hw, nh, dkh = q5.shape
    pad = np.zeros((B, hw, nh, slot - 2 * dkh - v5.shape[-1]), np.float32)
    return np.concatenate([q5, k5, v5, pad], axis=-1).reshape(B, hw, nh * slot)


def _jax_env(monkeypatch, slot_mode, tiles):
    """Set the JAX side's slot / tile switches."""
    if slot_mode == "tight":
        monkeypatch.setenv("CHEXPERT_ATTN_HIL_SLOT", "tight")
    else:
        monkeypatch.delenv("CHEXPERT_ATTN_HIL_SLOT", raising=False)
    if tiles:
        monkeypatch.setenv("CHEXPERT_ATTN_HIL_TILES", tiles)


def _jax_lse(lse_rows, hw, nh, dkh, dvh, wh):
    """The JAX kernel's (B, nq*nh*ROW_SUB, tq) lse rows -> (B, nh, hw)."""
    tq = jpa._hil_geometry(hw, nh, dkh, dvh, wh, 4)[0]
    B = lse_rows.shape[0]
    x = np.asarray(lse_rows).reshape(B, -1, nh, jpa.ROW_SUB, tq)[:, :, :, 0, :]
    return x.transpose(0, 2, 1, 3).reshape(B, nh, -1)[:, :, :hw]


def _operands(rw, rh, H, W):
    if rw is None:
        return None, None
    return (hil_rel_operand(torch.from_numpy(rw), W), hil_rel_operand(torch.from_numpy(rh), H))


@pytest.mark.parametrize("slot_mode", SLOTS)
@pytest.mark.parametrize("B,nh,H,W,dkh,dvh,relative,tiles", GEOMETRIES)
def test_plain_forward_matches_jax_hil_forward(B, nh, H, W, dkh, dvh, relative, tiles,
                                               slot_mode, monkeypatch):
    """Plain B5 vs ``_hil_forward``: out and lse per (batch, head, token); the
    port's ``aa_attention_hil`` vs its einsum ground truth."""
    _jax_env(monkeypatch, slot_mode, tiles)
    slot = jpa._hil_slot(dkh, dvh)
    q5, k5, v5, rw, rh, _ = _mk(B, nh, H, W, dkh, dvh, relative)
    P0 = _pack(q5, k5, v5, slot)
    Rw, Rh = _operands(rw, rh, H, W)
    if relative:  # the operand itself: block j is the window for query column j
        np.testing.assert_array_equal(Rw.numpy(), np.asarray(jpa._hil_rel_operand(rw, W)))
    jRw = None if Rw is None else jnp.asarray(Rw.numpy())
    jRh = None if Rh is None else jnp.asarray(Rh.numpy())
    jout, (_, jlse, _) = jpa._hil_forward(jnp.asarray(P0), jRw, jRh, H, W, dkh, dvh)
    out, lse = hil_attention_fwd_plain(torch.from_numpy(P0), Rw, Rh, H, W, dkh, dvh, slot)
    assert out.shape == (B, H * W, nh * dvh) and lse.shape == (B, nh, H * W)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(
        lse.numpy(), _jax_lse(jlse, H * W, nh, dkh, dvh, (W + H) if relative else 0), atol=ATOL)

    t = [None if x is None else torch.from_numpy(x) for x in (q5, k5, v5, rw, rh)]
    got = aa_attention_hil(*t, H, W, slot=slot)
    hm = [x.transpose(1, 2) for x in t[:3]]  # head-major for the einsum ground truth
    want, _ = aa_attention_einsum(*hm, t[3], t[4], H, W)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).numpy(), atol=ATOL)


@pytest.mark.parametrize("slot_mode", SLOTS)
@pytest.mark.parametrize("B,nh,H,W,dkh,dvh,relative,tiles", GEOMETRIES)
def test_plain_backward_matches_jax_hil_bwd_rule(B, nh, H, W, dkh, dvh, relative, tiles,
                                                 slot_mode, monkeypatch):
    """Plain B6 vs ``_hil_bwd_rule`` on the same residuals: dP lane by lane
    (every pad lane exactly 0), dRw, dRh."""
    _jax_env(monkeypatch, slot_mode, tiles)
    slot = jpa._hil_slot(dkh, dvh)
    q5, k5, v5, rw, rh, g = _mk(B, nh, H, W, dkh, dvh, relative)
    P0 = _pack(q5, k5, v5, slot)
    dout = g.reshape(B, H * W, nh * dvh)
    Rw, Rh = _operands(rw, rh, H, W)
    jRw = None if Rw is None else jnp.asarray(Rw.numpy())
    jRh = None if Rh is None else jnp.asarray(Rh.numpy())
    _, res = jpa._hil_fwd_rule(jnp.asarray(P0), jRw, jRh, H, W, dkh, dvh)
    jdP, jdRw, jdRh = jpa._hil_bwd_rule(H, W, dkh, dvh, res, jnp.asarray(dout))

    tP = torch.from_numpy(P0)
    out, lse = hil_attention_fwd_plain(tP, Rw, Rh, H, W, dkh, dvh, slot)
    dP, dRw, dRh = hil_attention_bwd_plain(tP, Rw, Rh, out, lse, torch.from_numpy(dout),
                                           H, W, dkh, dvh, slot)
    assert dP.shape == P0.shape
    lanes = dP.view(B, H * W, nh, slot)
    assert torch.count_nonzero(lanes[..., 2 * dkh + dvh:]) == 0  # pads exactly zero
    jdP = np.asarray(jdP)
    np.testing.assert_allclose(dP.numpy(), jdP, atol=RTOL_GRAD * np.abs(jdP).max())
    if not relative:
        assert dRw is None and dRh is None and jdRw is None
        return
    for name, got, want in (("dRw", dRw, jdRw), ("dRh", dRh, jdRh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=RTOL_GRAD * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("B,nh,H,W,dkh,dvh,relative,tiles", GEOMETRIES)
def test_hil_attention_grads_match_jax(B, nh, H, W, dkh, dvh, relative, tiles, monkeypatch):
    """The five gradients dq, dk, dv, drel_w, drel_h through ``HilAttention``
    (pack + operand build under autograd) vs ``jax.grad`` of the JAX
    ``aa_attention_hil``, and the outputs of the two."""
    _jax_env(monkeypatch, "64", tiles)
    q5, k5, v5, rw, rh, g = _mk(B, nh, H, W, dkh, dvh, relative)
    n = 5 if relative else 3

    def f(*a):
        out = jpa.aa_attention_hil(*a, *([None, None] if not relative else []), H, W)
        return jnp.sum(out * g), out

    jgrads, jout = jax.grad(f, argnums=tuple(range(n)), has_aux=True)(
        *map(jnp.asarray, (q5, k5, v5, rw, rh)[:n]))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q5, k5, v5, rw, rh)[:n]]
    kernels.reset_launch_counts()
    out = aa_attention_hil(*ts, *([None, None] if not relative else []), H, W)
    out.backward(torch.from_numpy(g))
    assert kernels.launch_counts() == {}  # CPU tensors: the plain versions, no launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL)
    for name, t, want in zip(("dq", "dk", "dv", "drel_w", "drel_h"), ts, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, atol=RTOL_GRAD * np.abs(want).max(),
                                   err_msg=name)


def test_wrappers_take_plain_on_cpu_and_guard():
    """CPU tensors run the plain versions through the wrappers; operands on a
    device without a kernel raise; bad shapes and slots raise; the names the
    launch counter uses are the C entries' stems."""
    B, nh, H, W, dkh, dvh = 1, 2, 4, 5, 20, 3
    slot = hil_slot(dkh, dvh)
    assert slot == 48 == hil_slot(20, 1) == hil_slot(20, 6) and hil_slot(20, 8) == 48
    q5, k5, v5, rw, rh, g = _mk(B, nh, H, W, dkh, dvh, True)
    P0 = torch.from_numpy(_pack(q5, k5, v5, slot))
    Rw, Rh = _operands(rw, rh, H, W)
    out, lse = hil_attention_fwd(P0, Rw, Rh, H, W, dkh, dvh, slot)
    dout = torch.from_numpy(g.reshape(B, H * W, nh * dvh))
    got = hil_attention_bwd(P0, Rw, Rh, out, lse, dout, H, W, dkh, dvh, slot)
    want = hil_attention_bwd_plain(P0, Rw, Rh, out, lse, dout, H, W, dkh, dvh, slot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # B6's plain version equals autograd through B5's plain version
    leaves = [t.clone().requires_grad_() for t in (P0, Rw, Rh)]
    hil_attention_fwd_plain(*leaves, H, W, dkh, dvh, slot)[0].backward(dout)
    for a, leaf in zip(want, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(),
                                   atol=RTOL_GRAD * leaf.grad.abs().max().item())
    meta = [t.to("meta") for t in (P0, Rw, Rh)]
    with pytest.raises(ValueError, match="no kernel"):
        hil_attention_fwd(*meta, H, W, dkh, dvh, slot)
    with pytest.raises(ValueError, match="slot"):
        hil_attention_fwd(P0, Rw, Rh, H, W, dkh, dvh, 40)
    with pytest.raises(ValueError, match="together"):
        hil_attention_fwd(P0, Rw, None, H, W, dkh, dvh, slot)
    with pytest.raises(ValueError, match="do not match"):
        hil_attention_fwd(P0, Rh, Rw, H, W, dkh, dvh, slot)
    assert FWD == "hil_attention_fwd" and all(p.startswith("hil_attention_bwd_")
                                              for p in BWD_PASSES)


# --- the module -------------------------------------------------------------

def _random_tree(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _random_tree(v, rng, path + (k,)) for k, v in tree.items()}
    if path[-1] == "kernel":
        fan_in = int(np.prod(tree.shape[:-1]))
        return (rng.randn(*tree.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    if path[-1] in ("scale", "var"):
        return rng.uniform(0.5, 1.5, tree.shape).astype(np.float32)
    scale = 0.5 if path[-1].startswith("key_rel") else 0.1  # else bias, mean
    return (scale * rng.randn(*tree.shape)).astype(np.float32)


@pytest.mark.parametrize("strides,out_channels", [(1, 16), (2, 16), (1, 4), (2, 4)],
                         ids=["s1_conv", "s2_conv", "s1_attn_only", "s2_attn_only"])
def test_aaconv_hil_matches_jax_module(strides, out_channels, monkeypatch):
    """``AAConv2d(attn_layout="hil")`` vs the JAX module under
    ``CHEXPERT_ATTN_LAYOUT=hil`` with carried weights: the output and every
    parameter gradient (``in_proj_qkv.weight`` in checkpoint order) and dx;
    the same state dict, loaded strictly, gives the bn, hil and einsum
    routes' outputs within 1e-5."""
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "hil")
    monkeypatch.delenv("CHEXPERT_ATTN_HIL_SLOT", raising=False)
    rng = np.random.RandomState(3)
    B, H, W, cin, dk, dv, nh = 2, 6, 5, 12, 16, 4, 2
    x = rng.randn(B, H * strides, W * strides, cin).astype(np.float32)
    jm = JaxAAConv2d(out_channels=out_channels, kernel_size=3, strides=strides, dk=dk, dv=dv,
                     nh=nh, relative=True, input_dims=(H, W), dtype=jnp.float32,
                     attn_impl="pallas")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _random_tree(shapes, rng)
    assert ("conv" in params) == (out_channels > dv)
    g = rng.randn(B, H, W, out_channels).astype(np.float32)

    def loss(p, xx):
        out = jm.apply({"params": p}, xx)
        return jnp.sum(out * g), out

    (jgp, jgx), jout = jax.grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    sd = state_dict_from_jax(params, {}, arch="aaresnet152")
    kw = dict(in_channels=cin, out_channels=out_channels, kernel_size=3, strides=strides, dk=dk,
              dv=dv, nh=nh, relative=True, input_dims=(H, W))
    outs = {}
    for impl, layout in (("pallas", "hil"), ("pallas", "bn"), ("einsum", "hil")):
        m = AAConv2d(attn_impl=impl, attn_layout=layout, **kw)
        m.load_state_dict(sd, strict=True)
        tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
        out = m(tx)
        outs[impl, layout] = out.detach().numpy().transpose(0, 2, 3, 1)
        if (impl, layout) != ("pallas", "hil"):
            continue
        out.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
        want = state_dict_from_jax(jax.device_get(jgp), {}, arch="aaresnet152")
        assert set(want) == {n for n, _ in m.named_parameters()}
        for n, p in m.named_parameters():
            w = want[n].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, atol=RTOL_GRAD * np.abs(w).max(),
                                       err_msg=n)
        jgx = np.asarray(jgx).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(tx.grad.numpy(), jgx, atol=RTOL_GRAD * np.abs(jgx).max())
    np.testing.assert_allclose(outs["pallas", "hil"], np.asarray(jout), atol=ATOL)
    for key in (("pallas", "bn"), ("einsum", "hil")):
        np.testing.assert_allclose(outs[key], outs["pallas", "hil"], atol=ATOL, err_msg=str(key))


def test_aadensenet_tiny_hil_logits_and_layout_switch(monkeypatch):
    """aadensenet-tiny under the hil layout: logits within 5e-4 of the JAX
    model under ``CHEXPERT_ATTN_LAYOUT=hil``. ``build_model`` reads the
    variable once, when the model is built, and rejects other values."""
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "hil")
    monkeypatch.delenv("CHEXPERT_ATTN_HIL_SLOT", raising=False)
    model, _ = jax_build_model("aadensenet-tiny", image_size=32, dtype=jnp.float32)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.RandomState(0)
    params, stats = _random_tree(shapes["params"], rng), _random_tree(shapes["batch_stats"], rng)
    want = np.asarray(jax.jit(lambda p, s, xx: model.apply(
        {"params": p, "batch_stats": s}, xx, train=False))(params, stats, jnp.asarray(x)))
    port = build_model("aadensenet-tiny", image_size=32)  # reads the variable: hil
    layouts = {m.attn_layout for m in port.modules() if isinstance(m, AAConv2d)}
    assert layouts == {"hil"}
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "bn")  # after the build: no effect
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert {m.attn_layout for m in port.modules() if isinstance(m, AAConv2d)} == {"hil"}
    bn = build_model("aadensenet-tiny", image_size=32)
    assert {m.attn_layout for m in bn.modules() if isinstance(m, AAConv2d)} == {"bn"}
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "lanes")
    with pytest.raises(ValueError, match="attn_layout"):
        build_model("aadensenet-tiny", image_size=32)
    with pytest.raises(ValueError, match="attn_layout"):
        build_model("aaresnet152", image_size=64, attn_layout="nhwc")
    build_model("aadensenet-tiny", image_size=32, attn_layout="hil")  # the argument wins
