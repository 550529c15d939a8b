"""The port's ensemble evaluation (eval/ensemble.py) against the JAX
package's, on the CPU, in float32.

K = 3 densenet-tiny checkpoints (numpy draws into the JAX trees, seeds 0-2)
are written twice under the same names: as the JAX package's
checkpoint_<k>.msgpack and, through ``state_dict_from_jax``, as the port's
checkpoint_<k>.pt. Both packages evaluate them on one synthetic valid set
(12 images at 32x32, batch 4, so three batches, the last one padded).

Tolerances: AUCs and per-class losses 1e-5 absolute (the same f32 forward;
the per-member sums and the mean over K in another order); the chunked
passes equal the unchunked one to 1e-6 (the same per-member numbers summed
in group order). The planner's search (``_fit_member_chunk``) is held to the
JAX function on the three cases of tests/test_ensemble.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chexpert_tpu_torch.eval.ensemble as ens
from chexpert_tpu.checkpoint import save_model_checkpoint as jax_save
from chexpert_tpu.data import Batches as JaxBatches
from chexpert_tpu.data import ChexpertIndex as JaxIndex
from chexpert_tpu.eval.ensemble import _fit_member_chunk as jax_fit_member_chunk
from chexpert_tpu.eval.ensemble import evaluate_ensemble as jax_evaluate_ensemble
from chexpert_tpu.eval.ensemble import list_checkpoints as jax_list_checkpoints
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.parallel.mesh import create_mesh
from chexpert_tpu.train import init_model
from chexpert_tpu_torch.checkpoint import save_model_checkpoint
from chexpert_tpu_torch.data import Batches, ChexpertIndex, make_synthetic_dataset
from chexpert_tpu_torch.eval import evaluate_ensemble, list_checkpoints
from chexpert_tpu_torch.models import build_model, state_dict_from_jax

ARCH, SIZE, K = "densenet-tiny", 32, 3
CPU = torch.device("cpu")


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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ensemble"))
    make_synthetic_dataset(root, n_train=8, n_valid=12, image_size=SIZE)
    jmodel, _ = jax_build_model(ARCH, image_size=SIZE, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    jax_dir, port_dir = os.path.join(root, "jax"), os.path.join(root, "port")
    os.makedirs(jax_dir)
    os.makedirs(port_dir)
    for k in range(K):
        rng = np.random.RandomState(k)
        params = _random_tree(shapes["params"], rng)
        stats = _random_tree(shapes["batch_stats"], rng)
        jax_save(os.path.join(jax_dir, f"checkpoint_{k}.msgpack"), params, stats, k, 1.0, 0.5)
        save_model_checkpoint(os.path.join(port_dir, f"checkpoint_{k}.pt"),
                              state_dict_from_jax(params, stats, ARCH), k, 1.0, 0.5)
    return root, jax_dir, port_dir, jmodel


def _port_batches(root):
    return Batches(ChexpertIndex(root, "valid"), 4, image_size=SIZE, workers=2)


def _port_metrics(root, port_dir, **kw):
    model = build_model(ARCH, image_size=SIZE)
    return evaluate_ensemble(model, list_checkpoints(port_dir), _port_batches(root), CPU,
                             torch.float32, ARCH, **kw)


def _assert_metrics_close(got, want, atol):
    for c in range(5):
        np.testing.assert_allclose(got["aucs"][c], want["aucs"][c], atol=atol, err_msg=f"auc {c}")
        np.testing.assert_allclose(got["loss"][c], want["loss"][c], atol=atol, err_msg=f"loss {c}")


@pytest.fixture(scope="module")
def unchunked(setup):
    root, _, port_dir, _ = setup
    return _port_metrics(root, port_dir)


def test_ensemble_metrics_match_jax(setup, unchunked):
    root, jax_dir, _, jmodel = setup
    params, stats = init_model(jmodel, jax.random.PRNGKey(9), (1, SIZE, SIZE, 3))
    batches = JaxBatches(JaxIndex(root, "valid", download=False), 4, image_size=SIZE, workers=2)
    mesh = create_mesh(1, 1, devices=jax.devices()[:1])
    want = jax_evaluate_ensemble(jmodel, jax_list_checkpoints(jax_dir), params, stats, batches,
                                 mesh)
    assert set(unchunked) == set(want)
    _assert_metrics_close(unchunked, want, 1e-5)
    assert np.isfinite(list(unchunked["aucs"].values())).all()


@pytest.mark.parametrize("chunk", [1, 2])
def test_chunked_equals_unchunked(setup, unchunked, chunk):
    root, _, port_dir, _ = setup
    _assert_metrics_close(_port_metrics(root, port_dir, member_chunk=chunk), unchunked, 1e-6)


def test_out_of_memory_retries_at_half_the_chunk(setup, unchunked, monkeypatch):
    """A torch.cuda.OutOfMemoryError on the first group of more than one
    member halves the chunk (3 -> 2) and the retried pass gives the same
    metrics."""
    root, _, port_dir, _ = setup
    seen, orig = [], ens._member_groups

    def groups(n, chunk):
        seen.append(chunk)
        for g in orig(n, chunk):
            if len(g) > 1 and len(seen) == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
            yield g

    monkeypatch.setattr(ens, "_member_groups", groups)
    log = []
    got = _port_metrics(root, port_dir, log=log.append)
    assert seen == [3, 2]
    assert log == ["[ensemble] device out of memory: retrying with member_chunk=2"]
    _assert_metrics_close(got, unchunked, 1e-6)


def test_out_of_memory_at_chunk_one_is_raised(setup, monkeypatch):
    root, _, port_dir, _ = setup

    def groups(n, chunk):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(ens, "_member_groups", groups)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _port_metrics(root, port_dir, member_chunk=1)


def test_list_checkpoints_picks_the_same_files(setup, tmp_path):
    _, jax_dir, port_dir, _ = setup
    ours = [os.path.splitext(os.path.basename(p))[0] for p in list_checkpoints(port_dir)]
    theirs = [os.path.splitext(os.path.basename(p))[0] for p in jax_list_checkpoints(jax_dir)]
    assert ours == theirs == [f"checkpoint_{k}" for k in range(K)]
    # other files are not members; a JAX .msgpack is refused with the exporter's name
    (tmp_path / "checkpoint_9.pt").write_bytes(b"")
    (tmp_path / "optim_checkpoint_9.pt").write_bytes(b"")
    (tmp_path / "checkpoints_tracker.csv").write_text("")
    assert list_checkpoints(str(tmp_path)) == [str(tmp_path / "checkpoint_9.pt")]
    with pytest.raises(ValueError, match="export_torch_state_dict"):
        list_checkpoints(jax_dir)


def test_empty_directory_raises_as_in_jax(setup, tmp_path):
    root, *_ = setup
    assert list_checkpoints(str(tmp_path)) == []
    with pytest.raises(AssertionError, match="no checkpoints found"):
        evaluate_ensemble(build_model(ARCH, image_size=SIZE), [], _port_batches(root), CPU,
                          torch.float32, ARCH)


@pytest.mark.parametrize("n,budget,costs", [
    # tests/test_ensemble.py: the measured efficientnet-b4 curve, fits at once, floors at 1
    (10, 14.6e9, lambda k: 0.82e9 if k == 1 else (0.168e9 + 1.68e9 * k)),
    (10, 1e12, lambda k: 1e9 * k),
    (8, 0.5e9, lambda k: 1e9 * k),
], ids=["b4_profile", "fits_first_try", "floors_at_one"])
def test_fit_member_chunk_equals_jax(n, budget, costs):
    ours, theirs = [], []
    got = ens._fit_member_chunk(n, budget, lambda k: ours.append(k) or costs(k))
    want = jax_fit_member_chunk(n, budget, lambda k: theirs.append(k) or costs(k))
    assert got == want and ours == theirs


def test_planner_takes_all_members_on_the_cpu(setup):
    root, *_ = setup
    model = build_model(ARCH, image_size=SIZE)
    assert ens._plan_member_chunk(model, 5, _port_batches(root), CPU, torch.float32) == 5


def test_device_budget_from_mem_get_info(monkeypatch):
    """0.9 x free - 1 GiB; CHEXPERT_HBM_GB overrides the card's total."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (60 * 2**30, 80 * 2**30))
    monkeypatch.delenv("CHEXPERT_HBM_GB", raising=False)
    assert ens._device_budget_bytes(torch.device("cuda")) == 0.9 * 60 * 2**30 - 2**30
    monkeypatch.setenv("CHEXPERT_HBM_GB", "32")
    assert ens._device_budget_bytes(torch.device("cuda")) == 0.9 * 12 * 2**30 - 2**30


def test_member_is_a_loaded_copy(setup):
    _, _, port_dir, _ = setup
    model = build_model(ARCH, image_size=SIZE)
    member = ens.load_member(model, os.path.join(port_dir, "checkpoint_1.pt"), ARCH)
    assert member is not model and not member.training
    w = member.features.conv0.weight
    assert not torch.equal(w, model.features.conv0.weight)
    assert ens.member_bytes(member) == sum(t.numel() * t.element_size()
                                           for t in member.state_dict().values())
