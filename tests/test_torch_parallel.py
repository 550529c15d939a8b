"""The port's multi-process pieces on the CPU against the JAX package's
(chexpert_tpu/parallel, data/pipeline.py): the grid of ranks and the
per-rank batch slices, ``initialize``, host-sliced ``Batches``, the
global BatchNorm on gloo ranks against ``F.batch_norm`` on the concatenated
batch, and ranks that build the index's processed cache together.

The JAX side runs over duck-typed devices and meshes: one device per JAX
process when ``model_parallel`` is 1, else ``model_parallel`` devices per
process, so a JAX data row lives on one process, and port rank ``r`` sits
where JAX device ``r`` does, its batch slice that of JAX process
``r // model_parallel``.

Tolerance of the BatchNorm check: max |port - reference| <= 1e-6 *
max(1, max |reference|), the reference in float64, the port in float32 on
per-channel reductions of 36 elements a rank.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chexpert_tpu.parallel.multihost as jax_mh
from _torch_dist_worker import BN_MOMENTUM, BN_SHAPE, bn_global_batch, launch
from chexpert_tpu.data import Batches as JaxBatches
from chexpert_tpu.data import ChexpertIndex as JaxIndex
from chexpert_tpu.parallel.mesh import create_mesh as jax_create_mesh
from chexpert_tpu_torch.data import Batches, ChexpertIndex, make_synthetic_dataset
from chexpert_tpu_torch.parallel import (
    create_hybrid_mesh,
    create_mesh,
    host_batch_slice_from_mesh,
    multihost,
)

BN_TOL = 1e-6


class _Device:
    def __init__(self, id_, process_index):
        self.id, self.process_index = id_, process_index


class _Mesh:
    """jax.sharding.Mesh's surface that chexpert_tpu.parallel.multihost reads."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.shape = dict(zip(axis_names, devices.shape))


@pytest.fixture
def jax_world(monkeypatch):
    """jax_world(world, model_parallel): fake the JAX processes of a port world."""

    def make(world, model_parallel):
        per = model_parallel if model_parallel > 0 else 1
        devices = [_Device(i, i // per) for i in range(world)]
        monkeypatch.setattr(jax, "devices", lambda: devices)
        monkeypatch.setattr(jax, "process_count", lambda: world // per)
        monkeypatch.setattr(jax_mh, "Mesh", _Mesh)
        return per

    return make


GRIDS = [(1, 0, 1), (1, 1, 1), (2, 0, 1), (2, 2, 1), (2, 1, 2), (4, 0, 1), (4, 2, 2),
         (4, 0, 2), (8, 4, 2), (8, 2, 4), (8, 0, 8)]


@pytest.mark.parametrize("world,dp,mp", GRIDS)
def test_rank_grid_and_batch_slices_match_jax(jax_world, monkeypatch, world, dp, mp):
    per = jax_world(world, mp)
    jmesh = jax_mh.create_hybrid_mesh(dp, mp)
    position = {d.id: (i, j) for (i, j), d in np.ndenumerate(jmesh.devices)}
    batch = 8 * jmesh.shape["data"]
    for r in range(world):
        mesh = create_hybrid_mesh(dp, mp, world=world, rank=r)
        assert mesh.shape == jmesh.shape
        assert (mesh.data_index, mesh.model_index) == position[r]
        monkeypatch.setattr(jax, "process_index", lambda: r // per)
        assert (host_batch_slice_from_mesh(mesh, batch)
                == jax_mh.host_batch_slice_from_mesh(jmesh, batch))


@pytest.mark.parametrize("world,dp,mp,batch", [
    (4, 3, 1, 12),   # the grid does not cover the ranks
    (4, 0, 3, 12),   # the model axis does not divide the ranks
    (4, 4, 1, 6),    # the global batch does not divide over the data rows
    (2, 0, 1, 7),
])
def test_bad_layouts_raise_jax_assertions(jax_world, monkeypatch, world, dp, mp, batch):
    jax_world(world, 1)
    monkeypatch.setattr(jax, "process_index", lambda: 0)

    def outcome(make_mesh, host_slice):
        try:
            host_slice(make_mesh(), batch)
        except AssertionError as e:
            return str(e)
        return None

    want = outcome(lambda: jax_mh.create_hybrid_mesh(dp, mp), jax_mh.host_batch_slice_from_mesh)
    got = outcome(lambda: create_hybrid_mesh(dp, mp, world=world, rank=0),
                  host_batch_slice_from_mesh)
    assert want is not None and got == want


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2), (0, 2), (3, 2)])
def test_one_process_mesh_larger_than_its_device_raises_as_jax(dp, mp):
    with pytest.raises(AssertionError) as jax_err:
        jax_create_mesh(dp, mp, devices=[_Device(0, 0)])
    with pytest.raises(AssertionError) as err:
        create_mesh(dp, mp)
    with pytest.raises(AssertionError) as hybrid_err:  # one process: create_mesh
        create_hybrid_mesh(dp, mp, world=1, rank=0)
    assert str(err.value) == str(hybrid_err.value) == str(jax_err.value)
    if dp > 0:
        assert str(err.value) == f"mesh {dp}x{mp} needs {dp * mp} devices, have 1"


_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "OMPI_COMM_WORLD_RANK",
                "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK")


def test_initialize_single_process_noop(monkeypatch):
    for v in _LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    assert not multihost.cluster_env_configured()
    assert multihost.initialize(torch.device("cpu")) is False
    assert not torch.distributed.is_initialized()
    assert (multihost.rank(), multihost.world_size(), multihost.is_primary()) == (0, 1, True)


def test_initialize_raises_when_cluster_configured(monkeypatch):
    """The torch twin of tests/test_multihost.py::
    test_initialize_raises_when_cluster_configured: a failed init raises when
    the environment configures a cluster, and only then."""
    calls = []

    def boom(*args, **kwargs):
        calls.append(kwargs)
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    for v in _LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    cpu = torch.device("cpu")
    # single-host values do not count as a cluster: no init is tried
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize(cpu) is False and not calls
    # multi-process values do, and the failure propagates
    for env in ({"WORLD_SIZE": "2", "RANK": "1"}, {"MASTER_ADDR": "127.0.0.1"},
                {"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "WORLD_SIZE": ""},
                {"OMPI_COMM_WORLD_SIZE": "2", "SLURM_NTASKS": "1", "WORLD_SIZE": ""}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert multihost.cluster_env_configured()
        with pytest.raises(RuntimeError, match="rendezvous unreachable"):
            multihost.initialize(cpu)
    assert [(c["rank"], c["world_size"]) for c in calls] == [(1, 2), (1, 2), (3, 4), (0, 2)]
    assert all(c["init_method"] == "env://" for c in calls)


@pytest.fixture(scope="module")
def valid_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_data"))
    make_synthetic_dataset(root, n_train=16, n_valid=10, image_size=32)
    return root


def _tile(per_rank):
    return [{k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            for parts in zip(*per_rank)]


@pytest.mark.parametrize("split,ranks,shuffle", [("valid", 2, False), ("valid", 4, False),
                                                 ("train", 4, True)])
def test_host_sliced_batches_tile_and_equal_jax(valid_root, split, ranks, shuffle):
    kw = dict(image_size=32, workers=2, shuffle=shuffle, augment=shuffle, seed=3)
    index = ChexpertIndex(valid_root, split)
    jindex = JaxIndex(valid_root, split, download=False)
    full = list(Batches(index, 8, **kw))
    per = 8 // ranks
    slices = [slice(r * per, (r + 1) * per) for r in range(ranks)]
    ours = [list(Batches(index, 8, **kw, host_slice=s)) for s in slices]
    for sl, rank_batches in zip(slices, ours):
        theirs = list(JaxBatches(jindex, 8, **kw, host_slice=sl))
        assert len(rank_batches) == len(theirs) == len(full)
        for a, b in zip(rank_batches, theirs):
            assert a["image"].shape[0] == per
            np.testing.assert_array_equal(np.broadcast_to(a["image"], b["image"].shape),
                                          b["image"])
            for k in ("label", "label_mask", "index", "mask"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for got, want in zip(_tile(ours), full):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if split == "valid":  # 10 = 8 + 2: the padding sits on the tail slices
        assert [b[-1]["mask"].tolist() for b in ours][-1] == [0.0] * per
        assert ours[0][-1]["mask"].tolist()[:2] == [1.0, 1.0]


def _close(got, want, what):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= BN_TOL * max(1.0, np.abs(want).max()), f"{what}: {err}"


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_global_batchnorm_equals_batch_norm_of_the_global_batch(tmp_path, model_parallel):
    """2 data rows (world 2, or world 4 under model_parallel 2, whose rows
    hold two ranks each and must count their examples once): each rank's
    output and input gradient equal F.batch_norm's rows of the concatenated
    batch, the parameter gradients summed over the data rows equal its
    parameter gradients, and every rank's running statistics equal its."""
    dp, world = 2, 2 * model_parallel
    prefix = str(tmp_path / "rank")
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    for res in launch(world, [worker, "bn", prefix, str(model_parallel)], str(tmp_path)):
        assert res.returncode == 0, res.stderr[-3000:]
    x, g, weight, bias = bn_global_batch(dp)
    xt = torch.tensor(x, requires_grad=True)
    w = torch.tensor(weight, requires_grad=True)
    b = torch.tensor(bias, requires_grad=True)
    rm, rv = torch.zeros(BN_SHAPE[1], dtype=torch.float64), torch.ones(BN_SHAPE[1],
                                                                       dtype=torch.float64)
    y = F.batch_norm(xt, rm, rv, w, b, training=True, momentum=BN_MOMENTUM, eps=1e-5)
    y.backward(torch.tensor(g))
    ranks = [np.load(f"{prefix}{r}.npz") for r in range(world)]
    dweight = dbias = 0.0
    for r, out in enumerate(ranks):
        lo, hi = out["rows"]
        assert (lo, hi) == (int(out["data_index"]) * BN_SHAPE[0],
                            (int(out["data_index"]) + 1) * BN_SHAPE[0])
        _close(out["y"], y.detach().numpy()[lo:hi], f"rank {r} output")
        _close(out["dx"], xt.grad.numpy()[lo:hi], f"rank {r} dx")
        _close(out["running_mean"], rm.numpy(), f"rank {r} running_mean")
        _close(out["running_var"], rv.numpy(), f"rank {r} running_var")
        if r % model_parallel == 0:  # one rank of each data row
            dweight, dbias = dweight + out["dweight"], dbias + out["dbias"]
    _close(dweight, w.grad.numpy(), "dweight")
    _close(dbias, b.grad.numpy(), "dbias")


def test_ranks_building_the_index_cache_together_read_whole_files(tmp_path):
    """4 ranks released together by a barrier build the index of a fixture
    with no processed cache yet: each writes the cache while others read it,
    and every rank must read the whole index (an unfinished cache file gave
    a rank an empty or short csv)."""
    root = str(tmp_path / "data")
    make_synthetic_dataset(root, n_train=600, n_valid=16, image_size=8)
    prefix = str(tmp_path / "rank")
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    for res in launch(4, [worker, "index", prefix, root], str(tmp_path)):
        assert res.returncode == 0, res.stderr[-3000:]
    want = {mode: [index.path(i) for i in range(len(index))]
            for mode, index in ((m, ChexpertIndex(root, m)) for m in ("train", "valid"))}
    assert len(want["train"]) == 600 and len(want["valid"]) == 16
    for r in range(4):
        with open(f"{prefix}{r}.json") as f:
            assert json.load(f) == want, f"rank {r}"


def test_ensemble_oom_on_one_rank_halves_the_chunk_on_every_rank(tmp_path):
    """2 gloo ranks evaluate a three-member ensemble over their slices of the
    valid batches; rank 1's first member forward raises
    torch.cuda.OutOfMemoryError. The ranks agree on it before the gather
    (one all-reduce), both halve the chunk 3 -> 2 and retry, and both finish
    with the metrics of one process within 1e-6. Before, rank 1 alone
    retried and waited in a gather that rank 0 had passed."""
    from _torch_dist_worker import ENS_ARCH, ENS_IMAGE, ensemble_batches

    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.eval.ensemble import evaluate_ensemble, list_checkpoints
    from chexpert_tpu_torch.models import build_model

    root, ckpts = str(tmp_path / "data"), tmp_path / "ckpts"
    make_synthetic_dataset(root, n_train=4, n_valid=12, image_size=ENS_IMAGE)
    ckpts.mkdir()
    for seed in range(3):
        model = build_model(ENS_ARCH, image_size=ENS_IMAGE,
                            generator=torch.Generator().manual_seed(seed))
        save_model_checkpoint(str(ckpts / f"checkpoint_{seed}.pt"), model.state_dict())
    prefix = str(tmp_path / "rank")
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    for res in launch(2, [worker, "ensemble_oom", prefix, root, str(ckpts), "1"], str(tmp_path),
                      timeout=240):
        assert res.returncode == 0, res.stderr[-3000:]
    want = evaluate_ensemble(build_model(ENS_ARCH, image_size=ENS_IMAGE),
                             list_checkpoints(str(ckpts)), ensemble_batches(root),
                             torch.device("cpu"), torch.float32, ENS_ARCH, log=lambda m: None)
    for r in range(2):
        with open(f"{prefix}{r}.json") as f:
            got = json.load(f)
        assert got["log"] == ["[ensemble] device out of memory: retrying with member_chunk=2"]
        for part in ("aucs", "loss"):
            for k, v in want[part].items():
                assert abs(got["metrics"][part][str(k)] - v) <= 1e-6, (r, part, k)
