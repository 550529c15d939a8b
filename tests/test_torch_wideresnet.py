"""The port's WideResNet, the CIFAR bench's train step and the bench's LR
schedules against the JAX package's, on the CPU, in float32.

WideResNet-10-2 with attention (nh 2) at 32x32: one block per layer, AA
convs on layers 2 and 3 (16x16 with dvh 3, 8x8 with dvh 6, dkh 20), the
maps of the bench's WideResNet-28-10. The JAX side runs its Pallas
attention in interpret mode on the CPU, as its own tests do.

Tolerances: eval logits 5e-4 (the forward-parity bound the JAX package met
against the torch reference); three bench train steps (SGD-Nesterov with
weight decay, linear warmup then cosine decay, the first step at LR 0) 1e-5
absolute on losses, parameters and BatchNorm statistics (the update is
linear in the gradient, which the two frameworks compute to ~1e-7), the
port's running variance compared after the n/(n-1) correction (ROADMAP.md
section C); schedules 1e-7 absolute at base LR 0.1 (JAX's float32 against
the port's float64 arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.cli import bench as jax_bench
from chexpert_tpu.models.densenet import AttnParams as JaxAttnParams
from chexpert_tpu.models.registry import OptimizerSpec as JaxSpec
from chexpert_tpu.models.resnet import WideResNet as JaxWideResNet
from chexpert_tpu.parallel.mesh import create_mesh as jax_create_mesh
from chexpert_tpu.train import TrainState as JaxState
from chexpert_tpu.train import init_model
from chexpert_tpu.train.optim import make_schedule as jax_make_schedule
from chexpert_tpu_torch.cli import bench
from chexpert_tpu_torch.models import (
    AAConv2d,
    AttnParams,
    OptimizerSpec,
    WideResNet,
    state_dict_from_jax,
)
from chexpert_tpu_torch.train import make_optimizer, make_schedule

SIZE, NH, N_CLASSES = 32, 2, 10
ARGV = ["wideresnet", "10", "2", "--attn", "--attn_nh", str(NH), "--lr", "0.1",
        "--lr_warmup_epochs", "1", "--lr_cos_max_epochs", "2", "--weight_decay", "1e-3"]


def _random_tree(tree, rng, path=()):
    """numpy values for a tree of ShapeDtypeStructs, scaled like trained
    weights (kaiming-like convs, BN statistics away from identity)."""
    if isinstance(tree, dict):
        return {k: _random_tree(v, rng, path + (k,)) for k, v in tree.items()}
    shape, leaf = tree.shape, path[-1]
    if leaf == "kernel":
        return (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(np.float32)
    if leaf in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if leaf in ("bias", "mean"):
        return (0.1 * rng.randn(*shape)).astype(np.float32)
    if leaf.startswith("key_rel"):
        return (0.5 * rng.randn(*shape)).astype(np.float32)
    raise KeyError(path)


def test_wideresnet_geometry_and_logits_match_jax():
    jmodel = JaxWideResNet(10, 2, num_classes=N_CLASSES, dtype=jnp.float32,
                           attn=JaxAttnParams(0.2, 0.1, NH, True, (SIZE, SIZE)))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.RandomState(0)
    params, stats = _random_tree(shapes["params"], rng), _random_tree(shapes["batch_stats"], rng)
    port = WideResNet(10, 2, num_classes=N_CLASSES, attn=AttnParams(0.2, 0.1, NH, True,
                                                                    (SIZE, SIZE)))
    port.load_state_dict(state_dict_from_jax(params, stats, arch="wideresnet"), strict=True)
    aa = [(*m.input_dims, m.dk // m.nh, m.dv // m.nh) for m in port.modules()
          if isinstance(m, AAConv2d)]
    assert aa == [(16, 16, 20, 3), (8, 8, 20, 6)]
    x = np.random.RandomState(1).randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def _bn_sizes(model, x):
    """n = B*H*W of each BatchNorm's input, by module name."""
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: sizes.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    return sizes


def test_three_bench_train_steps_follow_jax():
    """The bench's WideResNet optimizer (SGD-Nesterov, weight decay 1e-3,
    one epoch of two batches of linear warmup, then cosine over four): the
    JAX bench's jitted ``make_steps`` against the port's ``train_step``."""
    B, steps, n_batches = 4, 3, 2
    jargs = jax_bench.build_parser().parse_args(ARGV)
    jmodel, tx, jsched = jax_bench.build_bench_model(jargs, N_CLASSES, n_batches, jnp.float32)
    params, stats = init_model(jmodel, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3))
    init = state_dict_from_jax(*jax.device_get((params, stats)), arch="wideresnet")
    jstate = JaxState.create(params, stats, tx)
    jstep, _ = jax_bench.make_steps(jmodel, tx, jax_create_mesh(1, 1))

    args = bench.build_parser().parse_args(ARGV + ["--device", "cpu"])
    model, spec, kw = bench.build_bench_model(args, N_CLASSES, n_batches)
    assert spec == OptimizerSpec("sgd_nesterov", "cosine", weight_decay=1e-3)
    assert kw == {"warmup_steps": 2, "warmup_style": "linear", "cosine_decay_steps": 4}
    model.load_state_dict(init, strict=True)
    opt, sched, schedule = make_optimizer(spec, model.parameters(), args.lr, **kw)

    rng = np.random.RandomState(2)
    xs = [bench.normalize(rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8))
          for _ in range(steps)]
    ys = [rng.randint(0, N_CLASSES, B) for _ in range(steps)]
    for t, (x, y) in enumerate(zip(xs, ys)):
        assert schedule(t) == pytest.approx(float(jsched(t)), abs=1e-7)
        jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        tl = bench.train_step(model, opt, sched, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                              torch.from_numpy(y), torch.float32)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, err_msg=f"loss {t}")
    assert schedule(0) == 0.0

    want = state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                               arch="wideresnet")
    got = model.state_dict()
    sizes = _bn_sizes(model, torch.from_numpy(xs[0].transpose(0, 3, 1, 2).copy()))
    decay = 0.9 ** steps  # the part of running_var that is the init value 1
    moved = 0
    for key, w in want.items():
        g = got[key]
        if key.endswith("num_batches_tracked"):
            assert int(g) == steps
            continue
        if key.endswith("running_var"):
            n = sizes[key[: -len(".running_var")]]
            g = (g - decay) * (n - 1) / n + decay
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=key)
        moved += int(not np.array_equal(w.numpy(), init[key].numpy()))
    assert moved > 0


@pytest.mark.parametrize("style", ["hold", "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("kw", [
    dict(kind="sgd_nesterov"),
    dict(kind="sgd_nesterov", schedule="multistep", milestones=(2, 5)),
    dict(kind="rmsprop", schedule="exponential", decay_factor=0.9),
    dict(kind="rmsprop", schedule="exponential", decay_factor=0.97, decay_steps=4),
    dict(kind="sgd_nesterov", schedule="cosine"),
], ids=["constant", "multistep", "exponential", "staircase", "cosine"])
def test_schedules_match_jax(kw, warmup, style):
    cos = 7 if kw.get("schedule") == "cosine" else None
    sched = make_schedule(OptimizerSpec(**kw), 0.1, warmup, style, cos)
    jsched = jax_make_schedule(JaxSpec(**kw), 0.1, warmup, style, cos)
    for step in range(16):
        assert sched(step) == pytest.approx(float(jsched(step)), abs=1e-7), step


def test_bad_schedule_arguments_raise():
    with pytest.raises(ValueError, match="warmup_style"):
        make_schedule(OptimizerSpec("adam"), 0.1, 2, "cosine")
    with pytest.raises(ValueError, match="cosine_decay_steps"):
        make_schedule(OptimizerSpec("sgd_nesterov", "cosine"), 0.1)
