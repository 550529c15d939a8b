"""The port's Grad-CAM (interpret/gradcam.py) and attention-weight capture
(interpret/capture.py) against the JAX package's, on the CPU, in float32.

One model of each family: aadensenet-tiny at 32x32, a small attention-
augmented ResNet at 64x64 (basic blocks (1, 1, 11, 1): eleven blocks in
layer3, so the JAX package's sorted-path layer order, ``layer3.10`` before
``layer3.2``, shows), and efficientnet-b0 on a reduced block table at 32x32
(monkeypatched on both packages, as tests/test_torch_efficientnet.py does).
Weights are numpy draws from a seed into the JAX trees, carried over with
``state_dict_from_jax``. The JAX side runs as its own tests run it (Pallas
kernels in interpret mode; capture takes the einsum route on both sides).

The DenseNet and EfficientNet weights are numpy draws; the ResNet's are the
JAX package's initialization with each residual branch's last BatchNorm
scale set to 0.5, as a trained ResNet has its branches (``chip_smoke.py``'s
``damp_residuals`` does the same for aaresnet152). With numpy draws (BN
statistics not matched to the activations) the 13-block ResNet's logits
reach ~1600 and its deep attention layers saturate, so two f32 routes
differ by whole flips of a near one-hot softmax (ROADMAP.md section C,
item 8): rounding, not a port fault, and nothing a tolerance can name.

Tolerances: CAMs, logits and captured weights 1e-5 absolute (CAMs and
softmax weights lie in [0, 1], logits are O(1) here: the same f32 math in
another summation order; measured at most 2.4e-6). The forward-mode check of the site gradient
follows tests/test_gradcam.py: reverse-mode <g, d> against the forward-mode
derivative along a random direction d, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chexpert_tpu.models.efficientnet as jeff
import chexpert_tpu_torch.models.efficientnet as peff
from chexpert_tpu.interpret import grad_cam as jax_grad_cam
from chexpert_tpu.interpret.capture import capture_attention_weights as jax_capture
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.densenet import AttnParams as JaxAttnParams
from chexpert_tpu.models.resnet import ResNet as JaxResNet
from chexpert_tpu.train import init_model
from chexpert_tpu_torch.interpret import (
    attention_layers,
    capture_attention_weights,
    grad_cam,
    site_forward,
)
from chexpert_tpu_torch.models import AttnParams, ResNet, build_model, state_dict_from_jax

TOL = 1e-5
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
    if leaf.startswith("key_rel"):
        return (0.5 * rng.randn(*shape)).astype(np.float32)
    raise KeyError(path)


def _trees(model, size, seed=0):
    """(params, batch_stats) as jax arrays (numpy leaves cannot be indexed by
    the tracers of the JAX attention's relative-logit gather under jax.vjp)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.RandomState(seed)
    trees = _random_tree(shapes["params"], rng), _random_tree(shapes["batch_stats"], rng)
    return jax.tree_util.tree_map(jnp.asarray, trees)


def _densenet():
    jmodel, _ = jax_build_model("aadensenet-tiny", image_size=32, dtype=jnp.float32)
    params, stats = _trees(jmodel, 32)
    port = build_model("aadensenet-tiny", image_size=32)
    port.load_state_dict(state_dict_from_jax(*jax.device_get((params, stats))), strict=True)
    return jmodel, params, stats, port, 32


def _resnet(layers=(1, 1, 11, 1), residual_gamma=0.5):
    size = 64
    jmodel = JaxResNet("basic", layers, attn=JaxAttnParams(0.2, 0.1, 2, True, (size, size)),
                       dtype=jnp.float32)
    params, stats = init_model(jmodel, jax.random.PRNGKey(0), (1, size, size, 3))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * residual_gamma if path[-2].key == "bn2" and path[-1].key == "scale"
        else a, params)
    port = ResNet("basic", layers, attn=AttnParams(0.2, 0.1, 2, True, (size, size)))
    port.load_state_dict(state_dict_from_jax(*jax.device_get((params, stats)), arch="aaresnet152"),
                         strict=True)
    return jmodel, params, stats, port, size


def _efficientnet(monkeypatch):
    name, size = "efficientnet-b0", 32
    for mod in (jeff, peff):
        monkeypatch.setattr(mod, "B0_BLOCKS", SMALL_BLOCKS)
        monkeypatch.setitem(mod.SCALING_PARAMS, name, (1.0, 1.0, size, 0.0))
    jmodel = jeff.EfficientNet(name, num_classes=5, dtype=jnp.float32)
    params, stats = _trees(jmodel, size)
    port = peff.EfficientNet(name, num_classes=5)
    port.load_state_dict(state_dict_from_jax(*jax.device_get((params, stats)), arch=name),
                         strict=True)
    return jmodel, params, stats, port, size


def _family(name, monkeypatch):
    if name == "densenet":
        return _densenet()
    if name == "resnet":
        return _resnet((1, 1, 1, 1))
    return _efficientnet(monkeypatch)


def _input(size, batch=3, seed=1):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("cls_idx", [None, 2, [4, 0, 3]], ids=["argmax", "int", "per_image"])
@pytest.mark.parametrize("family", ["densenet", "resnet", "efficientnet"])
def test_grad_cam_matches_jax(family, cls_idx, monkeypatch):
    jmodel, params, stats, port, size = _family(family, monkeypatch)
    x = _input(size)
    variables = {"params": params, "batch_stats": stats}
    if cls_idx is None:  # jitted: one compile instead of an op-by-op trace
        want_cam, want_logits = jax.jit(lambda v, x: jax_grad_cam(jmodel, v, x))(
            variables, jnp.asarray(x))
    else:
        want_cam, want_logits = jax.jit(lambda v, x, c: jax_grad_cam(jmodel, v, x, c))(
            variables, jnp.asarray(x), jnp.asarray(cls_idx))
    cam, logits = grad_cam(port, _nchw(x), cls_idx)
    assert cam.shape == (3, 1, size, size) and cam.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=TOL)
    np.testing.assert_allclose(cam.numpy(), np.asarray(want_cam).transpose(0, 3, 1, 2),
                               atol=TOL)
    c = cam.numpy()
    assert c.min() >= 0.0 and c.max() <= 1.0
    if cls_idx is None:  # the top class's maps carry signal (a given class's may all be 0)
        assert c.std(axis=(1, 2, 3)).max() > 1e-3


def test_site_gradient_passes_the_forward_mode_check():
    """As tests/test_gradcam.py: the reverse-mode gradient at the site along a
    random direction equals the forward-mode derivative of the class logit
    (the site's output perturbed by a probe)."""
    port = build_model("densenet-tiny", image_size=16).eval()
    x = _nchw(_input(16, batch=1, seed=0))
    logits, feats = site_forward(port, x)
    cls = int(logits.argmax(dim=1)[0])
    (g,) = torch.autograd.grad(logits[0, cls], feats)
    d = torch.from_numpy(np.random.RandomState(0).randn(*feats.shape).astype(np.float32))
    site = port.get_submodule(port.gradcam_site)

    def score(probe):
        handle = site.register_forward_hook(lambda m, inputs, out: out + probe)
        try:
            return port(x)[0, cls]
        finally:
            handle.remove()

    _, jvp_val = torch.func.jvp(score, (torch.zeros_like(feats),), (d,))
    np.testing.assert_allclose(float((g * d).sum()), float(jvp_val.detach()), rtol=1e-5)


@pytest.mark.parametrize("family", ["densenet", "resnet", "efficientnet"])
def test_grad_cam_records_nothing_upstream_of_the_site(family, monkeypatch):
    """The graph behind the logits holds the head alone: its leaves are the
    site's output and the head's parameters, and no conv or norm node. The
    parameters require grad (as a training run's model has them) and get no
    .grad."""
    *_, port, size = _family(family, monkeypatch)
    logits, feats = site_forward(port, _nchw(_input(size)))
    assert feats.is_leaf and feats.requires_grad
    head = {id(p) for n, p in port.named_parameters() if n.split(".")[0] in ("classifier", "fc")}
    seen, stack, leaves, kinds = set(), [logits.grad_fn], [], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        kinds.add(type(fn).__name__)
        if hasattr(fn, "variable"):
            leaves.append(fn.variable)
        stack += [nxt for nxt, _ in fn.next_functions]
    assert any(v is feats for v in leaves)
    assert all(v is feats or id(v) in head for v in leaves), kinds
    assert not any(("Convolution" in k or "Norm" in k) for k in kinds), kinds
    grad_cam(port, _nchw(_input(size)))
    assert all(p.grad is None for p in port.parameters())


@pytest.mark.parametrize("family", ["densenet", "resnet"])
def test_capture_matches_jax_in_its_layer_order(family):
    """Chunk 2 over 5 images (a ragged tail), the layers in the JAX package's
    order (sorted path names: layer3.10 before layer3.2)."""
    jmodel, params, stats, port, size = _densenet() if family == "densenet" else _resnet()
    x = _input(size, batch=5, seed=3)
    want = jax_capture(jmodel, {"params": params, "batch_stats": stats}, jnp.asarray(x),
                       chunk=2)
    got = capture_attention_weights(port, _nchw(x), chunk=2)
    assert len(got) == len(want) == (1 if family == "densenet" else 13)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=TOL)
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)
    names = [n for n, _ in attention_layers(port)]
    if family == "resnet":
        assert names[:4] == ["layer2.0.conv1", "layer3.0.conv1", "layer3.1.conv1",
                             "layer3.10.conv1"]
        assert names.index("layer3.10.conv1") < names.index("layer3.2.conv1")
    assert all(m.attn_weights is None for _, m in attention_layers(port))


def test_capture_leaves_the_kernel_route_and_plain_models_alone():
    """A model without attention captures []; a call without capture keeps
    the kernel route (no weights kept) and gives the capture call's logits."""
    plain = build_model("densenet-tiny", image_size=32)
    x = _nchw(_input(32, batch=2))
    assert capture_attention_weights(plain, x) == []
    port = build_model("aadensenet-tiny", image_size=32).eval()
    with torch.no_grad():
        y = port(x)
        y_capture = port(x, capture_weights=True)
    (m,) = [m for _, m in attention_layers(port)]
    assert m.attn_weights is not None and m.attn_weights.shape[0] == 2
    m.attn_weights = None
    with torch.no_grad():
        port(x)
    assert m.attn_weights is None
    np.testing.assert_allclose(y.numpy(), y_capture.numpy(), atol=1e-5)
