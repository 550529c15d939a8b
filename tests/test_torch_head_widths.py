"""The attention ops at head widths past dkh 20 / dvh 8 against the JAX
package's, on the CPU, in float32.

The same seeded numpy inputs go through both. JAX runs its Pallas functions
in interpret mode, as its own tests run them on the CPU (highest matmul
precision from conftest): the head-major ``_flash_forward`` /
``_flash_bwd_rule`` against the port's plain B1 / B2, the heads-in-lanes
``_hil_forward`` / ``_hil_bwd_rule`` against the plain B5 / B6, at (dkh, dvh)
= (24, 8), (26, 12), (32, 16) and (64, 32), the widths the card's width
classes take (``fused_attention.width_class``), on maps of at most 4x5. Then
WideResNet-10-4 ``--attn --attn_nh 2`` at 16x16, whose 4x4 AA conv has
(dkh, dvh) = (25, 12): eval logits and one bench train step.

Tolerances: forward 1e-5 absolute (outputs ~1, lse ~5: the same f32
algorithm summed in another order); gradients 1e-5 relative to the largest
entry of each; the model's logits, loss, parameters and BatchNorm
statistics 1e-5 absolute (the port's running variance after the n/(n-1)
correction, ROADMAP.md section C).

Last, ``chip_smoke.py``'s bounds of the two backwards at these widths: each
operand read once, each gradient written once, one exp per (query, key)
pair, the passes' shares adding up to the whole.
"""

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
from chexpert_tpu_torch.ops.fused_attention import (
    rel_attention_bwd_plain,
    rel_attention_fwd,
    width_class,
)
from chexpert_tpu_torch.ops.hil_attention import (
    hil_attention_bwd,
    hil_attention_bwd_plain,
    hil_attention_fwd,
    hil_rel_operand,
    hil_slot,
)
from chexpert_tpu_torch.train import make_optimizer

ATOL = 1e-5
RTOL_GRAD = 1e-5  # of the largest |entry| of each gradient
WIDTHS = [(24, 8), (26, 12), (32, 16), (64, 32)]
B, NH, H, W = 2, 2, 4, 5


def _head_major(dkh, dvh, seed):
    rng = np.random.RandomState(seed)
    hw, L = H * W, dkh + W + H
    qr = rng.randn(B, NH, hw, L).astype(np.float32)
    qr[..., :dkh] *= dkh ** -0.5
    k = rng.randn(B, NH, hw, dkh).astype(np.float32)
    v = rng.randn(B, NH, hw, dvh).astype(np.float32)
    g = rng.randn(B, NH, hw, dvh).astype(np.float32)
    return qr, k, v, g


@pytest.mark.parametrize("dkh,dvh", WIDTHS)
def test_head_major_plain_matches_flash_forward_and_bwd_rule(dkh, dvh):
    """Plain B1 (out, lse) against ``_flash_forward``, and plain B2 (dqr with
    the RW / RH lanes, dk, dv) against ``_flash_bwd_rule`` on the same
    residuals and cotangent."""
    assert (dkh, dvh) != (20, 8) and dkh <= width_class(dkh, dvh)[0]
    qr, k, v, g = _head_major(dkh, dvh, seed=dkh + dvh)
    hw, bn = H * W, B * NH
    jout, res = jpa._flash_fwd_rule(*map(jnp.asarray, (qr, k, v)), H, W, dkh)
    _, _, hwp, _ = jpa._geometry(hw, bn, dkh, dvh, W + H, 4)
    jlse = np.asarray(jpa._unrows(res[4], hwp))[:, :hw]
    jgrads = jpa._flash_bwd_rule(H, W, dkh, res, jnp.asarray(g))

    tqr, tk, tv, tg = (torch.from_numpy(x.reshape(bn, hw, -1)) for x in (qr, k, v, g))
    kernels.reset_launch_counts()
    out, lse = rel_attention_fwd(tqr, tk, tv, H, W, dkh)  # the CPU wrapper: the plain version
    assert kernels.launch_counts() == {}
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(bn, hw, dvh), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL)
    grads = rel_attention_bwd_plain(tqr, tk, tv, out, lse, tg, H, W, dkh)
    for name, got, want in zip(("dqr", "dk", "dv"), grads, jgrads):
        want = np.asarray(want).reshape(bn, hw, -1)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=RTOL_GRAD * np.abs(want).max(),
                                   err_msg=name)


def _hil_jax_lse(lse_rows, dkh, dvh):
    """The JAX kernel's (B, nq*nh*ROW_SUB, tq) lse rows -> (B, nh, hw)."""
    hw = H * W
    tq = jpa._hil_geometry(hw, NH, dkh, dvh, W + H, 4)[0]
    x = np.asarray(lse_rows).reshape(B, -1, NH, jpa.ROW_SUB, tq)[:, :, :, 0, :]
    return x.transpose(0, 2, 1, 3).reshape(B, NH, -1)[:, :, :hw]


@pytest.mark.parametrize("dkh,dvh,slot_mode", [(*w, "64") for w in WIDTHS] + [(24, 8, "tight")])
def test_heads_in_lanes_plain_matches_hil_forward_and_bwd_rule(dkh, dvh, slot_mode,
                                                                monkeypatch):
    """Plain B5 (out, lse) against ``_hil_forward`` and plain B6 (dP lane by
    lane, every pad lane 0; dRw, dRh) against ``_hil_bwd_rule``, at the JAX
    package's default slot (the next multiple of 64) and, at (24, 8), the
    tight one (2 dkh + dvh = 56 lanes)."""
    if slot_mode == "tight":
        monkeypatch.setenv("CHEXPERT_ATTN_HIL_SLOT", "tight")
    else:
        monkeypatch.delenv("CHEXPERT_ATTN_HIL_SLOT", raising=False)
    slot = jpa._hil_slot(dkh, dvh)
    rng = np.random.RandomState(dkh * dvh)
    hw = H * W
    q5 = (rng.randn(B, hw, NH, dkh) * dkh ** -0.5).astype(np.float32)
    kv = rng.randn(B, hw, NH, dkh + dvh).astype(np.float32)
    pad = np.zeros((B, hw, NH, slot - 2 * dkh - dvh), np.float32)
    P0 = np.concatenate([q5, kv, pad], -1).reshape(B, hw, NH * slot)
    rw = (0.5 * rng.randn(dkh, 2 * W - 1)).astype(np.float32)
    rh = (0.5 * rng.randn(dkh, 2 * H - 1)).astype(np.float32)
    dout = rng.randn(B, hw, NH * dvh).astype(np.float32)
    Rw, Rh = hil_rel_operand(torch.from_numpy(rw), W), hil_rel_operand(torch.from_numpy(rh), H)
    jRw, jRh = jnp.asarray(Rw.numpy()), jnp.asarray(Rh.numpy())

    jout, res = jpa._hil_fwd_rule(jnp.asarray(P0), jRw, jRh, H, W, dkh, dvh)
    jdP, jdRw, jdRh = jpa._hil_bwd_rule(H, W, dkh, dvh, res, jnp.asarray(dout))
    tP = torch.from_numpy(P0)
    geo = (H, W, dkh, dvh, slot)
    kernels.reset_launch_counts()
    out, lse = hil_attention_fwd(tP, Rw, Rh, *geo)  # the CPU wrapper: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _hil_jax_lse(res[3], dkh, dvh), atol=ATOL)
    got = hil_attention_bwd(tP, Rw, Rh, out, lse, torch.from_numpy(dout), *geo)
    assert kernels.launch_counts() == {}
    for a, b in zip(got, hil_attention_bwd_plain(tP, Rw, Rh, out, lse,
                                                 torch.from_numpy(dout), *geo)):
        assert torch.equal(a, b)
    dP, dRw, dRh = got
    assert torch.count_nonzero(dP.view(B, hw, NH, slot)[..., 2 * dkh + dvh:]) == 0
    for name, a, want in (("dP", dP, jdP), ("dRw", dRw, jdRw), ("dRh", dRh, jdRh)):
        want = np.asarray(want)
        np.testing.assert_allclose(a.numpy(), want, atol=RTOL_GRAD * np.abs(want).max(),
                                   err_msg=name)


# --- WideResNet-10-4 --attn --attn_nh 2 at 16x16 ------------------------------

SIZE, N_CLASSES = 16, 10
ARGV = ["wideresnet", "10", "4", "--attn", "--attn_nh", "2", "--input_dims", "16", "16",
        "--lr", "0.1", "--lr_warmup_epochs", "0", "--weight_decay", "1e-3"]


def test_wideresnet_with_wide_heads_follows_jax():
    """Its AA convs have heads of (20, 6) at 8x8 and (25, 12) at 4x4: eval
    logits from the same weights, then one bench train step (SGD-Nesterov,
    weight decay) from the same batch, against the JAX bench's."""
    jargs = jax_bench.build_parser().parse_args(ARGV)
    jmodel, tx, _ = jax_bench.build_bench_model(jargs, N_CLASSES, 1, jnp.float32)
    params, stats = init_model(jmodel, jax.random.PRNGKey(3), (1, SIZE, SIZE, 3))
    init = state_dict_from_jax(*jax.device_get((params, stats)), arch="wideresnet")
    args = bench.build_parser().parse_args(ARGV + ["--device", "cpu"])
    model, spec, kw = bench.build_bench_model(args, N_CLASSES, 1)
    model.load_state_dict(init, strict=True)
    heads = [(*m.input_dims, m.dk // m.nh, m.dv // m.nh) for m in model.modules()
             if isinstance(m, AAConv2d)]
    assert heads == [(8, 8, 20, 6), (4, 4, 25, 12)]
    assert width_class(25, 12) == (32, 16)

    rng = np.random.RandomState(4)
    x = bench.normalize(rng.randint(0, 256, (4, SIZE, SIZE, 3)).astype(np.uint8))
    y = rng.randint(0, N_CLASSES, 4)
    tx_ = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    want = np.asarray(jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(tx_).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

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
            n = _bn_count(model, key[: -len(".running_var")], tx_)
            g = (g - 0.9) * (n - 1) / n + 0.9
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, err_msg=key)
        moved += int(not np.array_equal(w.numpy(), init[key].numpy()))
    assert moved > 0


def _bn_count(model, name, x):
    """n = B*H*W of the named BatchNorm's input."""
    mod = dict(model.named_modules())[name]
    seen = {}
    hook = mod.register_forward_hook(
        lambda m, inp, out: seen.__setitem__("n", inp[0].numel() // inp[0].shape[1]))
    with torch.no_grad():
        model.eval()(x)
    hook.remove()
    return seen["n"]


@pytest.mark.parametrize("dkh,dvh", [(20, 4), *WIDTHS, (128, 64), (160, 64), (150, 75)])
def test_backward_bounds_count_each_operand_once(monkeypatch, dkh, dvh):
    """B2 and B6's bounds (chip_smoke.py ``b2_bounds`` / ``b6_bounds``) at the
    real head widths: the whole backward moves its operands (B2: qr, k, v,
    out, dout, lse; B6: P, Rw, Rh, out, dout, lse) and its gradients once,
    takes one exp per pair, and the passes' bytes, operations and exps sum
    to it; no pass counts the f32 RC / dRC rows the passes hand on."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "sm_clock_mhz", lambda: 1980.0)
    hw, bn, es = H * W, B * NH, 2
    tok, pairs, L = bn * hw, bn * hw * hw, dkh + W + H
    b2 = chip_smoke.b2_bounds(bn, H, W, dvh, torch.bfloat16, dkh)
    assert b2["whole"]["bytes"] == (tok * (L + dkh + 3 * dvh) * es + tok * 4
                                    + tok * (L + dkh + dvh) * es)
    slot = hil_slot(dkh, dvh)
    P, rel = B * hw * NH * slot * es, (W * W + H * H) * dkh * 4
    b6 = chip_smoke.b6_bounds(B, NH, H, W, dvh, slot, torch.bfloat16, dkh)
    assert b6["whole"]["bytes"] == pytest.approx(2 * P + 2 * tok * dvh * es + tok * 4 + 2 * rel)
    for bounds, passes in ((b2, ("dkdv", "dq")), (b6, ("dq", "dkdv", "drel"))):
        assert bounds["whole"]["exps"] == pairs
        for key in ("bytes", "flops", "exps"):
            assert sum(bounds[p][key] for p in passes) == pytest.approx(bounds["whole"][key])
        whole = bounds["whole"]
        assert whole["bound_ms"] == max(whole["bytes_ms"], whole["ops_ms"], whole["exp_ms"])
