"""Heads past the largest width class, (dkh, dvh) > (128, 64), against the
JAX package's attention, on the CPU, in float32.

On the card such a head runs the chunked kernels of
``csrc/attention_wide.cuh`` in the (128, 64) class's libraries
(``fused_attention.width_plan``); on the CPU the wrappers run their plain
versions, which these tests hold to the JAX functions at the widths the
bench's flags reach past the classes: (160, 64) and (320, 128) of
``wideresnet 28 10 --attn --attn_k 0.5 --attn_v 0.2 --attn_nh 1``, the
ragged (150, 75) of ``densenet 12 100 --attn --attn_k 1.0 --attn_v 0.5
--attn_nh 1`` and (512, 256) of ``resnet 50`` with those flags, at B*nh <= 4
on maps from 1x1 to 8x8. JAX runs its Pallas functions in interpret mode,
as its own tests run them on the CPU. Then WideResNet-10-4 ``--attn
--attn_k 1.0 --attn_nh 1`` at 16x16, whose 4x4 AA conv has (dkh, dvh) =
(256, 25): one bench train step. Last, the chunk plan itself, with no JAX.

Tolerances as tests/test_torch_head_widths.py: forward 1e-5 absolute,
gradients 1e-5 relative to the largest entry of each, the model's loss,
parameters and BatchNorm statistics 1e-5 absolute.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.cli import bench as jax_bench
from chexpert_tpu.ops import pallas_attention as jpa
from chexpert_tpu.parallel.mesh import create_mesh as jax_create_mesh
from chexpert_tpu.train import TrainState as JaxState
from chexpert_tpu.train import init_model
from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.cli import bench
from chexpert_tpu_torch.models import AAConv2d, state_dict_from_jax
from chexpert_tpu_torch.ops import fused_attention
from chexpert_tpu_torch.ops.fused_attention import (
    rel_attention_bwd,
    rel_attention_fwd,
    width_plan,
)
from chexpert_tpu_torch.ops.hil_attention import (
    hil_attention_bwd,
    hil_attention_fwd,
    hil_rel_operand,
)
from chexpert_tpu_torch.train import make_optimizer

ATOL = 1e-5
RTOL_GRAD = 1e-5  # of the largest |entry| of each gradient
# ((dkh, dvh), (B, nh, H, W)): the wide heads at a map of the bench's layers
# (8x8), a ragged map (5x3), 4x4 and the smallest (1x1)
CASES = [((160, 64), (1, 2, 8, 8)), ((150, 75), (2, 1, 5, 3)), ((320, 128), (2, 1, 4, 4)),
         ((512, 256), (2, 2, 1, 1))]


def _assert_grads(names, got, wants, hw):
    """Each gradient within RTOL_GRAD of its largest entry. On a 1x1 map the
    softmax has one key, ds = p (dp - delta) is 0 and so is every gradient
    made of it (dq, the relative lanes, dk): those are held to RTOL_GRAD of
    the largest gradient of the call, as chip_smoke.py's layer gate holds
    them."""
    wants = [np.asarray(w).reshape(g.shape) for g, w in zip(got, wants)]
    largest = max(np.abs(w).max() for w in wants)
    for name, g, want in zip(names, got, wants):
        scale = np.abs(want).max() if hw > 1 else largest
        np.testing.assert_allclose(g.numpy(), want, atol=RTOL_GRAD * scale, err_msg=name)


@pytest.mark.parametrize("head,geo", CASES, ids=lambda x: "x".join(map(str, x)))
def test_head_major_matches_flash_forward_and_bwd_rule(head, geo):
    """B1 (out, lse) against ``_flash_forward`` and B2 (dqr with the RW / RH
    lanes, dk, dv) against ``_flash_bwd_rule`` on the same residuals and
    cotangent, through the wrappers' CPU route (no launch)."""
    (dkh, dvh), (B, nh, H, W) = head, geo
    assert width_plan(dkh, dvh)[1:] != (1, 1)
    rng = np.random.RandomState(dkh + dvh + H)
    hw, bn, L = H * W, B * nh, dkh + W + H
    qr = rng.randn(B, nh, hw, L).astype(np.float32)
    qr[..., :dkh] *= dkh ** -0.5
    k, v, g = (rng.randn(B, nh, hw, d).astype(np.float32) for d in (dkh, dvh, dvh))
    jout, res = jpa._flash_fwd_rule(*map(jnp.asarray, (qr, k, v)), H, W, dkh)
    _, _, hwp, _ = jpa._geometry(hw, bn, dkh, dvh, W + H, 4)
    jlse = np.asarray(jpa._unrows(res[4], hwp))[:, :hw]
    jgrads = jpa._flash_bwd_rule(H, W, dkh, res, jnp.asarray(g))

    tqr, tk, tv, tg = (torch.from_numpy(x.reshape(bn, hw, -1)) for x in (qr, k, v, g))
    kernels.reset_launch_counts()
    out, lse = rel_attention_fwd(tqr, tk, tv, H, W, dkh)
    grads = rel_attention_bwd(tqr, tk, tv, out, lse, tg, H, W, dkh)
    assert kernels.launch_counts() == {}
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(bn, hw, dvh), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL)
    _assert_grads(("dqr", "dk", "dv"), grads, jgrads, hw)


@pytest.mark.parametrize("head,geo", CASES, ids=lambda x: "x".join(map(str, x)))
def test_heads_in_lanes_matches_hil_forward_and_bwd_rule(head, geo):
    """B5 (out, lse) against ``_hil_forward`` and B6 (dP lane by lane, every
    pad lane 0; dRw, dRh) against ``_hil_bwd_rule``, at the JAX package's
    slot (the next multiple of 64)."""
    (dkh, dvh), (B, nh, H, W) = head, geo
    slot, hw = jpa._hil_slot(dkh, dvh), H * W
    rng = np.random.RandomState(dkh * dvh + H)
    q5 = (rng.randn(B, hw, nh, dkh) * dkh ** -0.5).astype(np.float32)
    kv = rng.randn(B, hw, nh, dkh + dvh).astype(np.float32)
    pad = np.zeros((B, hw, nh, slot - 2 * dkh - dvh), np.float32)
    P0 = np.concatenate([q5, kv, pad], -1).reshape(B, hw, nh * slot)
    rw = (0.5 * rng.randn(dkh, 2 * W - 1)).astype(np.float32)
    rh = (0.5 * rng.randn(dkh, 2 * H - 1)).astype(np.float32)
    dout = rng.randn(B, hw, nh * dvh).astype(np.float32)
    Rw, Rh = hil_rel_operand(torch.from_numpy(rw), W), hil_rel_operand(torch.from_numpy(rh), H)

    jout, res = jpa._hil_fwd_rule(jnp.asarray(P0), jnp.asarray(Rw.numpy()),
                                  jnp.asarray(Rh.numpy()), H, W, dkh, dvh)
    jgrads = jpa._hil_bwd_rule(H, W, dkh, dvh, res, jnp.asarray(dout))
    tq = jpa._hil_geometry(hw, nh, dkh, dvh, W + H, 4)[0]
    jlse = np.asarray(res[3]).reshape(B, -1, nh, jpa.ROW_SUB, tq)[:, :, :, 0, :]
    jlse = jlse.transpose(0, 2, 1, 3).reshape(B, nh, -1)[:, :, :hw]

    tP, geo5 = torch.from_numpy(P0), (H, W, dkh, dvh, slot)
    kernels.reset_launch_counts()
    out, lse = hil_attention_fwd(tP, Rw, Rh, *geo5)
    got = hil_attention_bwd(tP, Rw, Rh, out, lse, torch.from_numpy(dout), *geo5)
    assert kernels.launch_counts() == {}
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL)
    assert torch.count_nonzero(got[0].view(B, hw, nh, slot)[..., 2 * dkh + dvh:]) == 0
    _assert_grads(("dP", "dRw", "dRh"), got, jgrads, hw)


# --- WideResNet-10-4 --attn --attn_k 1.0 --attn_nh 1 at 16x16 -----------------

SIZE, N_CLASSES = 16, 10
ARGV = ["wideresnet", "10", "4", "--attn", "--attn_k", "1.0", "--attn_nh", "1",
        "--input_dims", "16", "16", "--lr", "0.1", "--lr_warmup_epochs", "0",
        "--weight_decay", "1e-3"]


def test_wideresnet_with_heads_past_the_classes_follows_jax():
    """Its 4x4 AA conv has one head of (256, 25), past the largest class: one
    bench train step (SGD-Nesterov, weight decay) from the same weights and
    batch against the JAX bench's: loss, parameters and BatchNorm
    statistics."""
    jargs = jax_bench.build_parser().parse_args(ARGV)
    jmodel, tx, _ = jax_bench.build_bench_model(jargs, N_CLASSES, 1, jnp.float32)
    params, stats = init_model(jmodel, jax.random.PRNGKey(5), (1, SIZE, SIZE, 3))
    init = state_dict_from_jax(*jax.device_get((params, stats)), arch="wideresnet")
    args = bench.build_parser().parse_args(ARGV + ["--device", "cpu"])
    model, spec, kw = bench.build_bench_model(args, N_CLASSES, 1)
    model.load_state_dict(init, strict=True)
    heads = [(*m.input_dims, m.dk // m.nh, m.dv // m.nh) for m in model.modules()
             if isinstance(m, AAConv2d)]
    assert heads == [(8, 8, 128, 12), (4, 4, 256, 25)]
    assert width_plan(256, 25) == ((128, 64), 2, 1)

    rng = np.random.RandomState(6)
    x = bench.normalize(rng.randint(0, 256, (4, SIZE, SIZE, 3)).astype(np.uint8))
    y = rng.randint(0, N_CLASSES, 4)
    tx_ = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    jstate = JaxState.create(params, stats, tx)
    jstep, _ = jax_bench.make_steps(jmodel, tx, jax_create_mesh(1, 1))
    jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
    opt, sched, _ = make_optimizer(spec, model.parameters(), args.lr, **kw)
    tl = bench.train_step(model, opt, sched, tx_, torch.from_numpy(y), torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    want_sd = state_dict_from_jax(jax.device_get(jstate.params),
                                  jax.device_get(jstate.batch_stats), arch="wideresnet")
    got_sd = model.state_dict()
    moved = 0
    for key, w in want_sd.items():
        g = got_sd[key]
        if key.endswith("num_batches_tracked"):
            assert int(g) == 1
            continue
        if key.endswith("running_var"):  # the port keeps the unbiased form: n/(n-1)
            mod = dict(model.named_modules())[key[: -len(".running_var")]]
            seen = {}
            hook = mod.register_forward_hook(
                lambda m, inp, out: seen.__setitem__("n", inp[0].numel() // inp[0].shape[1]))
            with torch.no_grad():
                model.eval()(tx_)
            hook.remove()
            n = seen["n"]
            g = (g - 0.9) * (n - 1) / n + 0.9
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, err_msg=key)
        moved += int(not np.array_equal(w.numpy(), init[key].numpy()))
    assert moved > 0


# --- the chunk plan ----------------------------------------------------------

def _spans(width: int, chunk: int, count: int):
    """[offset, end) of each of count chunks of a width, chunk lanes each."""
    return [(i * chunk, min((i + 1) * chunk, width)) for i in range(count)]


@pytest.mark.parametrize("dkh,dvh", [(1, 1), (20, 4), (128, 64), (129, 64), (128, 65),
                                     (150, 75), (160, 64), (256, 128), (320, 128),
                                     (512, 256), (640, 320), (1000, 3)])
def test_chunk_plan_covers_each_head_dimension_once(dkh, dvh):
    """width_plan's class and counts: a head the classes hold takes one chunk
    of each dimension in the smallest class holding it; a wider head takes
    the largest class with nk = ceil(dkh / 128), nv = ceil(dvh / 64), whose
    chunks [i * KW, min((i + 1) * KW, dkh)) tile the width once, every chunk
    full but a ragged last; the CUDA-core route's CW-lane chunks (CW read
    from the source) tile it likewise."""
    cls, nk, nv = width_plan(dkh, dvh)
    classes = fused_attention.WIDTH_CLASSES
    if dkh <= classes[-1][0] and dvh <= classes[-1][1]:
        assert (nk, nv) == (1, 1) and dkh <= cls[0] and dvh <= cls[1]
        assert not any(dkh <= kw and dvh <= vw for kw, vw in classes[:classes.index(cls)])
    else:
        assert cls == classes[-1] and (nk, nv) != (1, 1)
    src = (kernels.CSRC_DIR / "attention_wide.cuh").read_text()
    cw = int(re.search(r"constexpr int CW = (\d+);", src).group(1))
    for width, chunk, count in ((dkh, cls[0], nk), (dvh, cls[1], nv),
                                (dkh, cw, -(-dkh // cw)), (dvh, cw, -(-dvh // cw))):
        spans = _spans(width, chunk, count)
        assert spans[0][0] == 0 and spans[-1][1] == width
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(e - o == chunk for o, e in spans[:-1])
        assert 0 < spans[-1][1] - spans[-1][0] <= chunk


def test_wide_route_is_the_largest_class_alone():
    """The sources take a wide head only in the library of the largest class
    (attention_wide::route and attention_wide::BUILT), and every entry of
    every attention source takes the chunk count(s) the wrappers pass,
    checked by attention_wide::route."""
    src = (kernels.CSRC_DIR / "attention_wide.cuh").read_text()
    kw, vw = fused_attention.WIDTH_CLASSES[-1]
    assert f"constexpr bool BUILT = KW == {kw} && VW == {vw};" in src
    assert "nk != (dkh + KW - 1) / KW || nv != (dvh + VW - 1) / VW" in src
    for source in fused_attention.WIDTH_SOURCES:
        text = (kernels.CSRC_DIR / f"{source}.cu").read_text()
        assert '#include "attention_wide.cuh"' in text
        entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
        assert entries and all(re.search(r"\bint nk\b", params) for _, params in entries)
        assert "attention_wide::route(" in text
