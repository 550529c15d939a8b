"""The port's EfficientNet (models/efficientnet.py), its checkpoint keys, its
optimizer (RMSprop + per-step exponential decay) and its train-mode random
parts against the JAX package, on the CPU, in float32.

Weights are numpy draws from a seed into the JAX parameter trees (shapes from
``jax.eval_shape``), carried into the port with ``state_dict_from_jax(...,
arch=...)`` or the JAX exporter's ``.pth``; both load strictly.

Tolerances: eval logits 5e-4 (the forward-parity bound the JAX package met
against the torch reference); served probabilities 1e-4; optimizer steps
1e-6 absolute on O(1) parameters (the same update rule, rounded at the same
places except the LR's last bit); three train steps 1e-5 absolute on losses,
parameters and BN statistics, with BatchNorm's running variance compared
after the n/(n-1) correction (torch keeps the unbiased batch variance, Flax
the biased one; ROADMAP.md section C). The train steps run on a reduced
block table, set with monkeypatch on both packages' ``B0_BLOCKS`` /
``SCALING_PARAMS``, with drop-connect and dropout rates 0 (the frameworks'
random bits differ; the generator is tested on its own below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chexpert_tpu.models.efficientnet as jeff
import chexpert_tpu_torch.models.efficientnet as peff
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.pretrained import export_torch_state_dict
from chexpert_tpu.models.registry import OptimizerSpec as JaxSpec
from chexpert_tpu.train import TrainState as JaxState
from chexpert_tpu.train import init_model, make_train_step
from chexpert_tpu.train.optim import make_optimizer as jax_make_optimizer
from chexpert_tpu_torch.models import (
    OptimizerSpec,
    build_model,
    normalize_state_dict,
    optimizer_spec,
    state_dict_from_jax,
)
from chexpert_tpu_torch.models.efficientnet import EfficientNet, drop_connect, dropout
from chexpert_tpu_torch.train import TrainState, make_optimizer, prepare_image, train_step

ATOL = 5e-4
# one of each: an expand-1 block, a stride-2 block (library route) followed by
# a stride-1 k3 block with a skip, and two stride-1 k5 blocks
SMALL_BLOCKS = (
    (1, 32, 16, 3, 1, 1, 0.25),
    (2, 16, 24, 3, 2, 6, 0.25),
    (2, 24, 40, 5, 1, 6, 0.25),
)


def _random_tree(tree, rng, path=()):
    """numpy values for a tree of ShapeDtypeStructs, scaled like trained
    weights (kaiming-like convs, BN stats away from identity)."""
    if isinstance(tree, dict):
        return {k: _random_tree(v, rng, path + (k,)) for k, v in tree.items()}
    shape, leaf = tree.shape, path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    if leaf in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if leaf in ("bias", "mean"):
        return (0.1 * rng.randn(*shape)).astype(np.float32)
    raise KeyError(path)


def _jax_trees(model, size, seed=0):
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.RandomState(seed)
    return _random_tree(shapes["params"], rng), _random_tree(shapes["batch_stats"], rng)


def _jax_logits(model, params, stats, x_nhwc):
    fn = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x, train=False))
    return np.asarray(fn(params, stats, jnp.asarray(x_nhwc)))


def _input(size, batch=2, seed=1):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


@pytest.fixture(scope="module")
def b0():
    """The JAX efficientnet-b0 (f32) with random weights."""
    model, _ = jax_build_model("efficientnet-b0", dtype=jnp.float32)
    params, stats = _jax_trees(model, 64)
    return model, params, stats


def test_state_dict_from_jax_loads_strict_b0(b0):
    _, params, stats = b0
    sd = state_dict_from_jax(params, stats, arch="efficientnet-b0")
    port = build_model("efficientnet-b0")
    port.load_state_dict(sd, strict=True)
    assert not any(k.startswith("features.") for k in sd)
    w = params["blocks_1_1"]["depthwise_conv"]["kernel"]  # (k, k, 1, C) -> (C, 1, k, k)
    np.testing.assert_array_equal(port.blocks_1_1.depthwise_conv.weight.detach().numpy(),
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.blocks_1_1.se.reduce.bias.detach().numpy(),
                                  params["blocks_1_1"]["se"]["reduce"]["bias"])
    np.testing.assert_array_equal(port.stem_bn.running_var.numpy(), stats["stem_bn"]["var"])


def test_state_dict_from_jax_keys_and_shapes_b4():
    model, _ = jax_build_model("efficientnet-b4", dtype=jnp.float32)
    params, stats = _jax_trees(model, 32)
    sd = state_dict_from_jax(params, stats, arch="efficientnet-b4")
    want = build_model("efficientnet-b4").state_dict()
    assert set(sd) == set(want)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                           for k, v in want.items()}
    assert "blocks_3_1.depthwise_conv.weight" in sd and "stem_bn.running_mean" in sd


@pytest.mark.parametrize("size", [64, 57])
def test_b0_logits_match_jax(b0, size):
    """Eval logits, batch 2, f32, at an even and an odd size (TF-SAME pads
    the stride-2 layers asymmetrically on even sizes only)."""
    model, params, stats = b0
    x = _input(size)
    want = _jax_logits(model, params, stats, x)
    port = build_model("efficientnet-b0")
    port.load_state_dict(state_dict_from_jax(params, stats, arch="efficientnet-b0"), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_exported_pth_restores_through_serve_engine(b0, tmp_path):
    """A .pth from the JAX exporter (Flax paths, no num_batches_tracked) loads
    strictly through cli.serve.Engine; the engine's probabilities are the JAX
    model's."""
    from chexpert_tpu_torch.cli.serve import Engine, build_parser

    model, params, stats = b0
    path = str(tmp_path / "effnet.pth")
    export_torch_state_dict(params, stats, "efficientnet-b0", path)
    raw = torch.load(path, weights_only=True)
    assert "blocks_3_1.depthwise_conv.weight" in raw
    assert set(normalize_state_dict(raw, "efficientnet-b0")) == set(
        build_model("efficientnet-b0").state_dict())
    engine = Engine(build_parser().parse_args([
        "--restore_path", path, "--model", "efficientnet-b0", "--image_size", "64",
        "--compute_dtype", "float32", "--micro_batch", "2", "--device", "cpu"]))
    x = _input(64)
    want = 1.0 / (1.0 + np.exp(-_jax_logits(model, params, stats, x)))
    np.testing.assert_allclose(engine.forward(x), want, atol=1e-4)


def test_rmsprop_exponential_matches_optax():
    """Six steps of RMSprop under the per-step exponential decay: optax scales
    by the LR before its momentum trace, and so does the port."""
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    kw = dict(kind="rmsprop", schedule="exponential", decay_factor=0.9)
    tx, _ = jax_make_optimizer(JaxSpec(**kw), 0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched, _ = make_optimizer(OptimizerSpec(**kw), tp.values(), 0.05)
    for t, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=f"{k} step {t}")


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


def test_three_train_steps_follow_jax(monkeypatch):
    name, size, B, lr, steps = "efficientnet-b0", 32, 4, 1e-3, 3
    for mod in (jeff, peff):
        monkeypatch.setattr(mod, "B0_BLOCKS", SMALL_BLOCKS)
        monkeypatch.setitem(mod.SCALING_PARAMS, name, (1.0, 1.0, size, 0.0))
    spec = dict(kind="rmsprop", schedule="exponential", decay_factor=0.9)
    jmodel = jeff.EfficientNet(name, num_classes=5, drop_connect_rate=0.0, dtype=jnp.float32)
    params, stats = init_model(jmodel, jax.random.PRNGKey(0), (1, size, size, 3))
    tx, _ = jax_make_optimizer(JaxSpec(**spec), lr)
    jstate = JaxState.create(params, stats, tx)
    jstep = jax.jit(make_train_step(jmodel, tx))

    model = EfficientNet(name, num_classes=5, drop_connect_rate=0.0)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), jax.device_get(stats),
                                              arch=name), strict=True)
    assert optimizer_spec("efficientnet-b4") == OptimizerSpec("rmsprop", "exponential")
    opt, sched, _ = make_optimizer(OptimizerSpec(**spec), model.parameters(), lr)
    state = TrainState(model, opt, sched, generator=torch.Generator().manual_seed(0))

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

    want = state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                               arch=name)
    got = model.state_dict()
    sizes = _bn_sizes(model, torch.from_numpy(batches[0]["image"]))
    decay = 0.99 ** steps  # the part of running_var that is the init value 1
    for key, w in want.items():
        g = got[key]
        if key.endswith("num_batches_tracked"):
            assert int(g) == steps
            continue
        if key.endswith("running_var"):
            n = sizes[key[: -len(".running_var")]]
            g = (g - decay) * (n - 1) / n + decay
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=key)


@pytest.mark.parametrize("fn,shape", [(drop_connect, (64, 3, 2, 2)), (dropout, (64, 300))])
def test_random_parts_draw_from_the_generator(fn, shape):
    """Same seed, same mask; about 1 - rate kept; survivors scaled by
    1 / (1 - rate); nothing drawn in eval mode, and no generator in train
    mode raises instead of touching the global RNG."""
    rate = 0.4
    x = torch.rand(shape) + 0.5
    a = fn(x, rate, True, torch.Generator().manual_seed(3))
    b = fn(x, rate, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, fn(x, rate, True, torch.Generator().manual_seed(4)))
    kept = a != 0
    if fn is drop_connect:  # whole samples
        assert torch.equal(kept, kept[:, :1, :1, :1].expand_as(kept))
    frac = kept.float().mean().item()
    assert abs(frac - (1 - rate)) < (0.2 if fn is drop_connect else 0.03)
    torch.testing.assert_close(a[kept], x[kept] / (1 - rate))
    assert fn(x, rate, False, None) is x
    state = torch.random.get_rng_state()
    with pytest.raises(ValueError, match="Generator"):
        fn(x, rate, True, None)
    assert torch.equal(torch.random.get_rng_state(), state)


def test_train_forward_is_seeded_by_the_generator():
    """Two train-mode forwards of b0 from generators of one seed agree
    exactly; another seed gives other DropConnect / Dropout masks."""
    model = build_model("efficientnet-b0").train()
    x = torch.from_numpy(_input(32).transpose(0, 3, 1, 2).copy())

    def run(seed):
        with torch.no_grad():
            return model(x, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def test_optim_checkpoint_carries_the_generator(tmp_path):
    """The train-mode generator's state rides in the optimizer checkpoint
    beside RMSprop's state, so a resumed run draws the masks the
    uninterrupted run would have drawn."""
    from chexpert_tpu_torch.checkpoint import load_optim_checkpoint, save_optim_checkpoint

    model = build_model("efficientnet-b0")
    opt, sched, _ = make_optimizer(optimizer_spec("efficientnet-b0"), model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    sched.step()
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    path = str(tmp_path / "optim_checkpoint_latest.pt")
    save_optim_checkpoint(path, opt, sched, gen)
    want = torch.rand(4, generator=gen)
    model2 = build_model("efficientnet-b0")
    opt2, sched2, _ = make_optimizer(optimizer_spec("efficientnet-b0"), model2.parameters(), 1e-3)
    gen2 = torch.Generator().manual_seed(0)
    load_optim_checkpoint(path, opt2, sched2, gen2)
    assert torch.equal(torch.rand(4, generator=gen2), want)
    assert sched2.last_epoch == 1
    p1, p2 = next(iter(model.parameters())), next(iter(model2.parameters()))
    assert torch.equal(opt2.state[p2]["buf"], opt.state[p1]["buf"])


def test_registry_routes():
    with pytest.raises(ValueError, match="dw_impl"):
        build_model("efficientnet-b0", dw_impl="xla")
    lib = build_model("efficientnet-b0", dw_impl="library")
    assert {m.dw_impl for m in lib.modules() if hasattr(m, "dw_impl")} == {"library"}
    assert optimizer_spec("resnet152") == optimizer_spec("aaresnet152") == OptimizerSpec("adam")
