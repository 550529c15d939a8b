"""The port's loss, schedules, optimizers and train step against the JAX
package's, on the CPU, in float32.

Tolerances: losses and schedules 1e-6 relative (the same f32 formula);
optimizer steps 1e-6 absolute on O(1) parameters (the same update rule in
another order); three train steps of the tiny archs 1e-5 absolute on losses,
parameters and BN statistics: the two frameworks' gradients agree to ~3e-7
absolute, and the steps use aadensenet121's SGD-Nesterov (lr 0.1), whose
update is linear in the gradient. (Adam divides each gradient by its own
scale, so on the tiny archs' ~1e-5 gradients a 1e-7 difference moves a
parameter by a visible fraction of lr; its update rule is checked above.)
BatchNorm's running variance differs by
framework: torch keeps the unbiased batch variance, Flax the biased one, so
the port's running_var is compared after the n/(n-1) correction, n = B*H*W
of that layer's input (ROADMAP.md section C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.registry import OptimizerSpec as JaxSpec
from chexpert_tpu.train import TrainState as JaxState
from chexpert_tpu.train import init_model, make_train_step
from chexpert_tpu.train import loss as jloss
from chexpert_tpu.train.optim import make_optimizer as jax_make_optimizer
from chexpert_tpu.train.optim import make_schedule as jax_make_schedule
from chexpert_tpu_torch.models import OptimizerSpec, build_model, optimizer_spec, state_dict_from_jax
from chexpert_tpu_torch.train import (
    TrainState,
    bce_with_logits,
    make_optimizer,
    make_schedule,
    prepare_image,
    train_loss,
    train_step,
)


def test_bce_and_masked_loss_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 5) * 4).astype(np.float32)
    targets = (rng.rand(6, 5) < 0.5).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    label_mask = (rng.rand(6, 5) < 0.8).astype(np.float32)
    t = [torch.from_numpy(x) for x in (logits, targets, mask, label_mask)]
    np.testing.assert_allclose(bce_with_logits(t[0], t[1]).numpy(),
                               np.asarray(jloss.bce_with_logits(logits, targets)), rtol=1e-6)
    for lm in (None, label_mask):
        want = float(jloss.train_loss(logits, targets, mask, lm))
        got = float(train_loss(t[0], t[1], t[2], None if lm is None else t[3]))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # an all-padding batch divides by 1, not 0
    assert float(train_loss(t[0], t[1], torch.zeros(6))) == 0.0


@pytest.mark.parametrize("kw,warmup", [
    (dict(kind="adam"), 0),
    (dict(kind="sgd_nesterov", schedule="multistep", milestones=(3, 5)), 0),
    (dict(kind="sgd_nesterov", schedule="multistep", milestones=(3, 5)), 2),
    (dict(kind="rmsprop", schedule="exponential", decay_factor=0.9), 2),
    (dict(kind="rmsprop", schedule="exponential", decay_factor=0.9, decay_steps=3), 1),
])
def test_schedules_match_jax(kw, warmup):
    sched = make_schedule(OptimizerSpec(**kw), 0.1, warmup)
    jsched = jax_make_schedule(JaxSpec(**kw), 0.1, warmup, "hold")
    for step in range(14):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6, err_msg=step)


@pytest.mark.parametrize("kw,warmup", [
    (dict(kind="adam", schedule="multistep", milestones=(2,)), 0),
    (dict(kind="sgd_nesterov", schedule="multistep", milestones=(1, 2)), 1),
    (dict(kind="rmsprop"), 0),  # torch applies the lr inside the momentum: constant lr
])
def test_optimizer_steps_match_optax(kw, warmup):
    """Four steps on the same params and grads; the scheduler's LR at step t
    is the schedule's, as optax's count-indexed schedule."""
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
             for _ in range(4)]
    tx, _ = jax_make_optimizer(JaxSpec(**kw), 0.05, warmup, "hold")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched, schedule = make_optimizer(OptimizerSpec(**kw), tp.values(), 0.05, warmup)
    for t, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(schedule(t), rel=1e-12)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=f"{k} step {t}")


def test_prepare_image_whitens_and_expands():
    x = torch.tensor([[[[0], [255]]]], dtype=torch.uint8)  # (1, 1, 2, 1)
    y = prepare_image(x)
    assert y.shape == (1, 3, 1, 2) and y.dtype == torch.float32
    np.testing.assert_allclose(y[0, :, 0, 1].numpy(), [(1 - 0.5330) / 0.0349] * 3, rtol=1e-6)


def _bn_sizes(model, image):
    """n = B*H*W of each BatchNorm's input, by module name."""
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: sizes.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        model.eval()(prepare_image(image))
    for h in hooks:
        h.remove()
    return sizes


@pytest.mark.parametrize("name", ["densenet-tiny", "aadensenet-tiny"])
def test_three_train_steps_follow_jax(name):
    size, B, lr, steps = 32, 4, 0.1, 3
    jmodel, _ = jax_build_model(name, image_size=size, dtype=jnp.float32, attn_impl="pallas")
    _, jspec = jax_build_model("aadensenet121", image_size=size)
    params, stats = init_model(jmodel, jax.random.PRNGKey(0), (1, size, size, 3))
    tx, _ = jax_make_optimizer(jspec, lr)
    jstate = JaxState.create(params, stats, tx)
    jstep = jax.jit(make_train_step(jmodel, tx))

    model = build_model(name, image_size=size, attn_impl="pallas")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), jax.device_get(stats)),
                          strict=True)
    opt, sched, _ = make_optimizer(optimizer_spec("aadensenet121"), model.parameters(), lr)
    state = TrainState(model, opt, sched)

    rng = np.random.RandomState(2)
    batches = [{"image": rng.randn(B, size, size, 1).astype(np.float32),
                "label": (rng.rand(B, 5) < 0.4).astype(np.float32),
                "label_mask": np.ones((B, 5), np.float32),
                "mask": np.ones((B,), np.float32)} for _ in range(steps)]
    for batch in batches:
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tl = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.float32)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    assert state.step == int(jstate.step) == steps

    want = state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    sizes = _bn_sizes(model, torch.from_numpy(batches[0]["image"]))
    decay = 0.9 ** steps  # the part of running_var that is the init value 1
    for key, w in want.items():
        g = got[key]
        if key.endswith("num_batches_tracked"):
            assert int(g) == steps
            continue
        if key.endswith("running_var"):
            n = sizes[key[: -len(".running_var")]]
            g = (g - decay) * (n - 1) / n + decay
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=key)
