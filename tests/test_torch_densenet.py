"""The port's DenseNet / AA-DenseNet against the JAX package's, on the CPU.

Weights are drawn with numpy from a seed into the JAX parameter trees
(shapes from ``jax.eval_shape``), carried into the port with
``state_dict_from_jax`` (strict load), and eval logits are compared in
float32 within 5e-4 — the forward-parity bound the JAX package met against
the torch reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.pretrained import export_torch_state_dict
from chexpert_tpu_torch.checkpoint import load_model_checkpoint, save_model_checkpoint
from chexpert_tpu_torch.models import (
    AAConv2d,
    OptimizerSpec,
    build_model,
    normalize_state_dict,
    optimizer_spec,
    state_dict_from_jax,
)

ATOL = 5e-4


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


def _jax_model(name, size, attn_impl="pallas", seed=0):
    model, _ = jax_build_model(name, image_size=size, dtype=jnp.float32, attn_impl=attn_impl)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.RandomState(seed)
    return model, _random_tree(shapes["params"], rng), _random_tree(shapes["batch_stats"], rng)


def _jax_logits(model, params, stats, x_nhwc):
    fn = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x, train=False))
    return np.asarray(fn(params, stats, jnp.asarray(x_nhwc)))


def _port_logits(name, size, sd, x_nhwc, attn_impl="pallas"):
    m = build_model(name, image_size=size, attn_impl=attn_impl, device="cpu")
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return m.eval()(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy())).numpy()


def _input(size, batch=2, seed=1):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["densenet-tiny", "aadensenet-tiny"])
def test_state_dict_from_jax_loads_strict(name):
    model, params, stats = _jax_model(name, 32)
    sd = state_dict_from_jax(params, stats)
    port = build_model(name, image_size=32)
    port.load_state_dict(sd, strict=True)  # raises on any missing/extra key
    assert set(sd) == set(port.state_dict())
    w = params["conv0"]["kernel"]  # HWIO -> OIHW
    np.testing.assert_array_equal(port.features.conv0.weight.detach().numpy(),
                                  w.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("name,attn_impl", [
    ("densenet-tiny", "pallas"),
    ("aadensenet-tiny", "pallas"),
    ("aadensenet-tiny", "einsum"),
])
def test_tiny_logits_match_jax(name, attn_impl):
    model, params, stats = _jax_model(name, 32, attn_impl)
    x = _input(32)
    want = _jax_logits(model, params, stats, x)
    got = _port_logits(name, 32, state_dict_from_jax(params, stats), x, attn_impl)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["pallas", "einsum"])
def test_aadensenet121_logits_match_jax(attn_impl):
    """Full-width aadensenet121 at 64x64, batch 2, on both attention routes
    (the port's kernel wrapper runs its plain version on the CPU; JAX runs
    its Pallas kernel in interpret mode)."""
    model, params, stats = _jax_model("aadensenet121", 64, attn_impl)
    x = _input(64)
    want = _jax_logits(model, params, stats, x)
    got = _port_logits("aadensenet121", 64, state_dict_from_jax(params, stats), x, attn_impl)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_exported_pth_loads_strict(tmp_path):
    """A .pth from the JAX exporter (no 'features.' prefix for aadensenet*,
    no num_batches_tracked) loads strict through the port's store."""
    name = "aadensenet-tiny"
    model, params, stats = _jax_model(name, 32)
    path = str(tmp_path / "model.pth")
    export_torch_state_dict(params, stats, name, path)
    raw = torch.load(path, weights_only=True)
    assert not any(k.startswith("features.") for k in raw)
    ck = load_model_checkpoint(path)
    x = _input(32)
    got = _port_logits(name, 32, normalize_state_dict(ck["state_dict"]), x)
    np.testing.assert_allclose(got, _jax_logits(model, params, stats, x), atol=ATOL)


def test_legacy_zoo_keys_normalize():
    sd = {"features.denseblock1.denselayer1.norm.1.weight": torch.ones(2),
          "features.denseblock1.denselayer1.norm.1.running_mean": torch.zeros(2),
          "features.denseblock1.denselayer1.conv.2.weight": torch.ones(1)}
    out = normalize_state_dict(sd)
    assert set(out) == {"features.denseblock1.denselayer1.norm1.weight",
                        "features.denseblock1.denselayer1.norm1.running_mean",
                        "features.denseblock1.denselayer1.norm1.num_batches_tracked",
                        "features.denseblock1.denselayer1.conv2.weight"}


def test_store_round_trip_and_msgpack_refusal(tmp_path):
    m = build_model("aadensenet-tiny", image_size=32)
    path = str(tmp_path / "ck.pt")
    save_model_checkpoint(path, m.state_dict(), global_step=7, avg_auc=0.5)
    ck = load_model_checkpoint(path)
    assert ck["global_step"] == 7 and ck["avg_auc"] == 0.5
    m2 = build_model("aadensenet-tiny", image_size=32,
                     generator=torch.Generator().manual_seed(1))
    m2.load_state_dict(ck["state_dict"], strict=True)
    for k, v in m.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k]), k
    with pytest.raises(ValueError, match="export_torch_state_dict"):
        load_model_checkpoint(str(tmp_path / "checkpoint.msgpack"))


def test_registry_guards():
    with pytest.raises(RuntimeError, match="not supported"):
        build_model("vgg16")
    aares = build_model("aaresnet152", image_size=64)
    assert sum(isinstance(m, AAConv2d) for m in aares.modules()) == 47
    assert optimizer_spec("aaresnet152") == OptimizerSpec("adam")
    for flag in ("remat", "slim_bwd", "slim_block", "concat_free"):
        with pytest.raises(ValueError):
            build_model("aadensenet-tiny", image_size=32, **{flag: True})
    with pytest.raises(ValueError):
        build_model("aadensenet-tiny", image_size=32, chunk_size=128)
    with pytest.raises(ValueError, match="attn_impl"):
        build_model("aadensenet-tiny", image_size=32, attn_impl="pallas-fusepack")
    for impl in ("pallas-fusedpack", "pallas-fusedpack5d", "pallas-bd", "pallas-einsum"):
        build_model("aadensenet-tiny", image_size=32, attn_impl=impl)
    build_model("aadensenet-tiny", image_size=32, prefix_stats=True)  # eval no-op
