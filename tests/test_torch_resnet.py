"""The port's ResNet / attention-augmented ResNet (models/resnet.py) against
the JAX package's, on the CPU, in float32.

Small models: ``ResNet("bottleneck", (1, 1, 1, 1))`` (every stage's widths,
one block each) and ``ResNet("basic", (1, 1, 1, 1))`` at 64x64, batch 2, with
and without attention on layers 2-4 (8x8 / 4x4 / 2x2 maps). Weights are numpy
draws from a seed into the JAX parameter trees (shapes from
``jax.eval_shape``), carried into the port with ``state_dict_from_jax(...,
arch=...)`` or the JAX exporter's ``.pth``; both load strictly. The JAX side
runs its Pallas attention in interpret mode, under
``CHEXPERT_ATTN_LAYOUT=hil`` where the port's layout is ``hil``.

Tolerances: eval logits 5e-4 (the forward-parity bound the JAX package met
against the torch reference). The three Adam train steps are held against
the JAX package run in float64 (``jax.enable_x64``, scoped to the test): on
the CPU the JAX package's float32 gradient of this net is up to 8e-2
(relative to each tensor's largest entry) from its own float64 gradient and
its third loss 1e-3 off, while the port's float32 gradient is within 2e-5
of the float64 one of either package, and the two packages agree to 2e-6 in
float64. Losses: 1e-5. BatchNorm statistics after the first step, before
any parameter differs: 1e-5, the running variance after the n/(n-1)
correction (torch keeps the unbiased batch variance, Flax the biased one;
ROADMAP.md section C). Parameters after three steps at lr 1e-4: Adam divides
each entry's gradient by its own size, so an entry whose gradient is
within float32 rounding of zero moves by lr to either side at each step;
about 1% of the entries do. So each tensor's mean difference is held to
1e-5 and its largest to 2 * lr * steps, what sign flips can make."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chexpert_tpu_torch.models as port_models
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.densenet import AttnParams as JaxAttnParams
from chexpert_tpu.models.pretrained import export_torch_state_dict
from chexpert_tpu.models.registry import OptimizerSpec as JaxSpec
from chexpert_tpu.models.resnet import ResNet as JaxResNet
from chexpert_tpu.train import TrainState as JaxState
from chexpert_tpu.train import init_model, make_train_step
from chexpert_tpu.train.optim import make_optimizer as jax_make_optimizer
from chexpert_tpu_torch.checkpoint import load_model_checkpoint
from chexpert_tpu_torch.cli.serve import Engine, build_parser
from chexpert_tpu_torch.data import ATTR_NAMES
from chexpert_tpu_torch.models import (
    AAConv2d,
    AttnParams,
    OptimizerSpec,
    ResNet,
    build_model,
    normalize_state_dict,
    optimizer_spec,
    state_dict_from_jax,
)
from chexpert_tpu_torch.train import TrainState, make_optimizer, prepare_image, train_step

ATOL = 5e-4
SIZE = 64
ARCH = "aaresnet152"  # names the key scheme (no "features." prefix) for the converters


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
    if leaf.startswith("key_rel"):
        return (0.5 * rng.randn(*shape)).astype(np.float32)
    raise KeyError(path)


def _models(block, aa, attn_layout="bn", nh=8, jax_init=False):
    """(JAX model, its trees, the port's model with them loaded strictly).
    The trees are numpy draws scaled like trained weights, or, with
    ``jax_init``, the JAX package's own initialization (BN statistics (0, 1):
    a fresh model, whose logits stay of order 1)."""
    jattn = JaxAttnParams(0.2, 0.1, nh, True, (SIZE, SIZE)) if aa else None
    jmodel = JaxResNet(block, (1, 1, 1, 1), attn=jattn, dtype=jnp.float32)
    if jax_init:
        params, stats = jax.device_get(init_model(jmodel, jax.random.PRNGKey(0),
                                                  (1, SIZE, SIZE, 3)))
    else:
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
        rng = np.random.RandomState(0)
        params = _random_tree(shapes["params"], rng)
        stats = _random_tree(shapes["batch_stats"], rng)
    attn = AttnParams(0.2, 0.1, nh, True, (SIZE, SIZE)) if aa else None
    port = ResNet(block, (1, 1, 1, 1), attn=attn, attn_layout=attn_layout)
    port.load_state_dict(state_dict_from_jax(params, stats, arch=ARCH), strict=True)
    return jmodel, params, stats, port


def _jax_logits(jmodel, params, stats, x_nhwc):
    fn = jax.jit(lambda p, s, x: jmodel.apply({"params": p, "batch_stats": s}, x, train=False))
    return np.asarray(fn(params, stats, jnp.asarray(x_nhwc)))


def _input(batch=2, seed=1):
    return np.random.RandomState(seed).randn(batch, SIZE, SIZE, 3).astype(np.float32)


def _port_logits(port, x_nhwc):
    with torch.no_grad():
        return port.eval()(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy())).numpy()


@pytest.mark.parametrize("block,aa,layout", [
    ("bottleneck", False, "bn"),
    ("bottleneck", True, "bn"),
    ("bottleneck", True, "hil"),
    ("basic", True, "hil"),
])
def test_small_resnet_logits_match_jax(block, aa, layout, monkeypatch):
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", layout)  # the JAX side's switch
    jmodel, params, stats, port = _models(block, aa, layout)
    if aa:
        mods = [m for m in port.modules() if isinstance(m, AAConv2d)]
        assert [m.input_dims for m in mods] == [(8, 8), (4, 4), (2, 2)]
        assert {m.attn_layout for m in mods} == {layout}
        if block == "bottleneck":  # the aaresnet152 head geometry: dkh 20, dvh 1 / 3 / 6
            assert [(m.dk // m.nh, m.dv // m.nh) for m in mods] == [(20, 1), (20, 3), (20, 6)]
    x = _input()
    np.testing.assert_allclose(_port_logits(port, x), _jax_logits(jmodel, params, stats, x),
                               atol=ATOL)


def test_exported_pth_loads_strict_and_engine_serves(tmp_path, monkeypatch):
    """A .pth from the JAX exporter (downsample.0 / .1, no num_batches_tracked)
    loads strictly through the port's store, and ``cli.serve.Engine`` answers
    from it on the CPU when asked for ``--device cpu``."""
    jmodel, params, stats, port = _models("bottleneck", True, "hil", nh=2, jax_init=True)
    path = str(tmp_path / "model.pth")
    n = export_torch_state_dict(params, stats, ARCH, path)
    raw = torch.load(path, weights_only=True)
    assert len(raw) == n and "layer2.0.downsample.0.weight" in raw
    assert "layer2.0.conv2.key_rel_w" in raw and "fc.bias" in raw
    fresh = ResNet("bottleneck", (1, 1, 1, 1), attn=AttnParams(0.2, 0.1, 2, True, (SIZE, SIZE)))
    fresh.load_state_dict(normalize_state_dict(load_model_checkpoint(path)["state_dict"], ARCH),
                          strict=True)
    x = _input()
    want = _jax_logits(jmodel, params, stats, x)
    np.testing.assert_allclose(_port_logits(fresh, x), want, atol=ATOL)

    # the registry has no small ResNet: the engine builds this one under the arch's name
    def small(name, image_size=320, **kw):
        assert name == ARCH and image_size == SIZE
        return ResNet("bottleneck", (1, 1, 1, 1), attn_layout="hil",
                      attn=AttnParams(0.2, 0.1, 2, True, (image_size, image_size)))

    monkeypatch.setattr(port_models, "build_model", small)
    engine = Engine(build_parser().parse_args([
        "--restore_path", path, "--model", ARCH, "--image_size", str(SIZE),
        "--compute_dtype", "float32", "--device", "cpu"]))
    img = np.random.RandomState(5).randint(0, 256, (80, 72), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="JPEG", quality=90)
    probs = engine.predict(buf.getvalue())
    assert list(probs) == list(ATTR_NAMES)
    xb = engine.preprocess(buf.getvalue())[None].astype(np.float32)
    ref = 1.0 / (1.0 + np.exp(-_jax_logits(jmodel, params, stats, xb)[0]))
    assert 0.02 < ref.min() and ref.max() < 0.98  # not saturated: the comparison means something
    np.testing.assert_allclose([probs[k] for k in ATTR_NAMES], ref, atol=1e-4)


class _ShapeOnly:
    """Stands in for ``torch.save``: keeps the exporter's keys and shapes."""

    def __init__(self):
        self.shapes = None

    def __call__(self, sd, path):
        self.shapes = {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["resnet152", "aaresnet152"])
def test_registry_keys_and_shapes_equal_the_exporters(name, monkeypatch):
    """``build_model(name)``'s state dict against ``export_torch_state_dict``
    of the JAX model's trees (shapes only: zero-stride arrays from
    ``jax.eval_shape``, no 152-layer forward), and the arch's optimizer."""
    jmodel, jspec = jax_build_model(name, image_size=SIZE, dtype=jnp.float32, attn_impl="einsum")
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    saved = _ShapeOnly()
    monkeypatch.setattr(torch, "save", saved)
    export_torch_state_dict(zeros["params"], zeros["batch_stats"], name, "unused.pth")
    monkeypatch.undo()
    port = build_model(name, image_size=SIZE)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == saved.shapes
    aa = [m for m in port.modules() if isinstance(m, AAConv2d)]
    assert len(aa) == (47 if name == "aaresnet152" else 0)  # 8 + 36 + 3 blocks of layers 2-4
    assert {(m.dk // m.nh, m.dv // m.nh, m.slot) for m in aa} <= {(20, 1, 48), (20, 3, 48),
                                                                  (20, 6, 48)}
    assert optimizer_spec(name) == OptimizerSpec("adam") and jspec == JaxSpec("adam")
    normalized = normalize_state_dict({k: torch.empty(0) for k in saved.shapes}, name)
    assert set(normalized) == set(port.state_dict())  # only num_batches_tracked is added


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


def test_three_adam_train_steps_follow_jax(monkeypatch):
    """The small AA-ResNet under the hil layout, Adam (the arch's optimizer),
    against the JAX package in float64: losses of three steps, BN statistics
    after the first, parameters after the third."""
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "hil")
    B, lr, steps = 4, 1e-4, 3
    _, params, stats, model = _models("bottleneck", True, "hil", nh=2, jax_init=True)
    opt, sched, _ = make_optimizer(optimizer_spec(ARCH), model.parameters(), lr)
    state = TrainState(model, opt, sched)
    rng = np.random.RandomState(2)
    batches = [{"image": rng.randn(B, SIZE, SIZE, 1).astype(np.float32),
                "label": (rng.rand(B, 5) < 0.4).astype(np.float32),
                "label_mask": np.ones((B, 5), np.float32),
                "mask": np.ones((B,), np.float32)} for _ in range(steps)]

    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

        jmodel = JaxResNet("bottleneck", (1, 1, 1, 1), dtype=jnp.float64,
                           attn=JaxAttnParams(0.2, 0.1, 2, True, (SIZE, SIZE)))
        tx, _ = jax_make_optimizer(JaxSpec("adam"), lr)
        jstate = JaxState.create(f64(params), f64(stats), tx)
        jstep = jax.jit(make_train_step(jmodel, tx))
        jlosses, jstates = [], []
        for batch in batches:
            jstate, jl = jstep(jstate, f64(batch))
            assert jl.dtype == jnp.float64
            jlosses.append(float(jl))
            jstates.append(jax.tree_util.tree_map(np.asarray, (jstate.params,
                                                               jstate.batch_stats)))
        assert int(jstate.step) == steps

    sizes = _bn_sizes(model, torch.from_numpy(batches[0]["image"]))
    init = _flat(stats)
    for i, batch in enumerate(batches):
        tl = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.float32)
        np.testing.assert_allclose(float(tl), jlosses[i], atol=1e-5)
        if i == 0:  # the statistics of one batch through equal parameters
            for key, w in state_dict_from_jax({}, jstates[0][1], arch=ARCH).items():
                g = model.state_dict()[key]
                if key.endswith("num_batches_tracked"):
                    assert int(g) == 1
                    continue
                if key.endswith("running_var"):
                    # 0.1 * the batch variance was added: unbiased here, biased in Flax
                    n = sizes[key[: -len(".running_var")]]
                    base = 0.9 * torch.from_numpy(init[key])
                    g = (g - base) * (n - 1) / n + base
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=key)
    assert state.step == steps

    got = dict(model.named_parameters())
    want = state_dict_from_jax(jstates[-1][0], {}, arch=ARCH)
    assert set(want) == set(got)
    for key, w in want.items():
        diff = (got[key].detach() - w).abs()
        assert float(diff.mean()) <= 1e-5, key
        assert float(diff.max()) <= 2 * lr * steps + 1e-6, key


def _flat(stats):
    """The initial running statistics under the port's keys."""
    return {k: v.numpy() for k, v in state_dict_from_jax({}, stats, arch=ARCH).items()
            if not k.endswith("num_batches_tracked")}
