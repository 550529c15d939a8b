"""The port's data layer, metrics, tracker and config against the JAX
package's, on the CPU.

The port reads and writes CSV with the ``csv`` module where the JAX package
uses pandas; these tests hold its fixture, index and batches equal to the
JAX ones: fixture files byte for byte, labels and indices exactly, batches
exactly (the same PIL decode and numpy arithmetic)."""

import json
import os

import numpy as np
import pytest

from chexpert_tpu.checkpoint.tracker import update_tracker as jax_update_tracker
from chexpert_tpu.configs import Config as JaxConfig
from chexpert_tpu.data import Batches as JaxBatches
from chexpert_tpu.data import ChexpertIndex as JaxIndex
from chexpert_tpu.data import extract_patient_ids as jax_extract_patient_ids
from chexpert_tpu.data import make_synthetic_dataset as jax_make_synthetic_dataset
from chexpert_tpu.eval.metrics import compute_metrics as jax_compute_metrics
from chexpert_tpu_torch.checkpoint import update_tracker
from chexpert_tpu_torch.configs import Config
from chexpert_tpu_torch.data import (
    DIR_NAME,
    Batches,
    ChexpertIndex,
    extract_patient_ids,
    make_synthetic_dataset,
)
from chexpert_tpu_torch.data.chexpert import read_csv, write_csv
from chexpert_tpu_torch.eval import avg_auc, compute_metrics

FIXTURE = dict(n_train=24, n_valid=12, image_size=48, views_per_study=2, uncertain_frac=0.5)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(port's fixture, JAX's fixture), same arguments and seed."""
    port = str(tmp_path_factory.mktemp("port_fixture"))
    jax_root = str(tmp_path_factory.mktemp("jax_fixture"))
    make_synthetic_dataset(port, **FIXTURE)
    jax_make_synthetic_dataset(jax_root, **FIXTURE)
    return port, jax_root


def test_fixture_files_equal_jax(roots):
    port, jax_root = roots
    for split in ("train", "valid"):
        a = open(os.path.join(port, DIR_NAME, f"{split}.csv"), "rb").read()
        b = open(os.path.join(jax_root, DIR_NAME, f"{split}.csv"), "rb").read()
        assert a == b, split
    idx = ChexpertIndex(port, "train")
    for pos in range(len(idx)):
        rel = os.path.relpath(idx.path(pos), port)
        assert (open(os.path.join(port, rel), "rb").read()
                == open(os.path.join(jax_root, rel), "rb").read()), rel


def _assert_same_index(idx, jidx):
    assert len(idx) == len(jidx)
    np.testing.assert_array_equal(idx.all_labels(), jidx.all_labels())
    np.testing.assert_array_equal(idx.all_indices(), jidx.all_indices())
    for pos in range(len(idx)):
        assert os.path.basename(idx.path(pos)) == os.path.basename(jidx.path(pos))
        assert idx.index(pos) == jidx.index(pos)
        np.testing.assert_array_equal(idx.labels(pos), jidx.labels(pos))


@pytest.mark.parametrize("mode,kw", [
    ("train", dict(uncertain_policy="ones")),
    ("train", dict(uncertain_policy="zeros")),
    ("train", dict(uncertain_policy="ignore")),
    ("train", dict(mini_data=5)),
    ("train", dict(data_filter={"Frontal/Lateral": "Frontal"})),
    ("train", dict(data_filter={"Cardiomegaly": 1.0})),
    ("valid", {}),
    ("vis", {}),
])
def test_index_matches_jax(roots, mode, kw):
    port, jax_root = roots
    idx = ChexpertIndex(port, mode, **kw)
    jidx = JaxIndex(jax_root, mode, download=False, **kw)
    _assert_same_index(idx, jidx)
    if mode == "vis":
        assert idx.vis_attrs == jidx.vis_attrs and idx.vis_idxs == jidx.vis_idxs
    if "data_filter" in kw:
        saved = os.path.join(port, DIR_NAME, "processed_training_data_filters.json")
        assert json.load(open(saved)) == kw["data_filter"]
    ids = idx.all_indices()[:4]
    np.testing.assert_array_equal(extract_patient_ids(idx, ids),
                                  jax_extract_patient_ids(jidx, ids))


def test_policies_differ_on_the_fixture(roots):
    ones = ChexpertIndex(roots[0], "train", uncertain_policy="ones").all_labels()
    zeros = ChexpertIndex(roots[0], "train", uncertain_policy="zeros").all_labels()
    ignore = ChexpertIndex(roots[0], "train", uncertain_policy="ignore").all_labels()
    assert ones.sum() > zeros.sum() and (ignore == -1).any()


def test_jax_index_reads_the_ports_caches(roots, tmp_path):
    """The port's processed caches (written with csv) read back through the
    JAX package's pandas index equal what JAX derives from its own files."""
    root = str(tmp_path)
    make_synthetic_dataset(root, **FIXTURE)
    ChexpertIndex(root, "train", uncertain_policy="zeros")  # writes the caches
    _assert_same_index(JaxIndex(root, "train", uncertain_policy="zeros", download=False),
                       JaxIndex(roots[1], "train", uncertain_policy="zeros", download=False))
    _assert_same_index(JaxIndex(root, "valid", download=False),
                       JaxIndex(roots[1], "valid", download=False))


def test_missing_dataset_and_test_mode_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not download"):
        ChexpertIndex(str(tmp_path), "train")
    # test mode reads a csv of paths: a missing one raises as in JAX
    with pytest.raises(FileNotFoundError):
        ChexpertIndex(str(tmp_path / "test.csv"), "test")
    with pytest.raises(ValueError, match="not one of"):
        ChexpertIndex(str(tmp_path), "predict")


@pytest.mark.parametrize("columns", ["all", "path_only"])
def test_test_mode_equals_jax(roots, tmp_path, columns):
    """Test mode (predict's input): a csv of absolute image paths, with every
    column of valid.csv or with the Path column alone (the competition's
    test csv); the Path joined to '.', every label 0, the label columns a
    Path-only csv lacks appended, mini_data not applied, as in JAX."""
    port, _ = roots
    header, rows = read_csv(os.path.join(port, DIR_NAME, "valid.csv"))
    rows = [[os.path.join(port, r[0]), *r[1:]] for r in rows]
    test_csv = str(tmp_path / "test.csv")
    if columns == "all":
        write_csv(test_csv, header, rows)
    else:
        write_csv(test_csv, ["Path"], [[r[0]] for r in rows])
    idx = ChexpertIndex(test_csv, "test", mini_data=3)
    jidx = JaxIndex(test_csv, "test", mini_data=3, download=False)
    assert len(idx) == len(jidx) == FIXTURE["n_valid"]
    assert idx.attr_idxs == jidx.attr_idxs
    for pos in range(len(idx)):
        assert idx.path(pos) == jidx.path(pos) == rows[pos][0]
        assert idx.index(pos) == jidx.index(pos)
        np.testing.assert_array_equal(idx.labels(pos), jidx.labels(pos))
    np.testing.assert_array_equal(idx.all_labels(), jidx.all_labels())
    assert not idx.all_labels().any()
    ids = idx.all_indices()
    np.testing.assert_array_equal(extract_patient_ids(idx, ids),
                                  jax_extract_patient_ids(jidx, ids))


@pytest.mark.parametrize("augment,drop_last", [(False, False), (True, True)])
def test_batches_equal_jax(roots, augment, drop_last):
    port, jax_root = roots
    kw = dict(shuffle=True, augment=augment, image_size=40, workers=3, drop_last=drop_last,
              seed=3, epoch=1)
    ours = list(Batches(ChexpertIndex(port, "train", uncertain_policy="ignore"), 10, **kw))
    theirs = list(JaxBatches(JaxIndex(jax_root, "train", uncertain_policy="ignore",
                                      download=False), 10, **kw))
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for a, b in zip(ours, theirs):
        assert a["image"].shape[-1] == 1  # the 1 -> 3 expand runs on the device
        np.testing.assert_array_equal(np.broadcast_to(a["image"], b["image"].shape), b["image"])
        for k in ("label", "label_mask", "index", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    outputs = rng.randn(40, 5)
    targets = (rng.rand(40, 5) < 0.4).astype(np.float32)
    targets[:, 2] = 1.0  # a single-valued class: AUC NaN, skipped by the mean
    losses = rng.rand(40, 5)
    got, want = compute_metrics(outputs, targets, losses), jax_compute_metrics(outputs, targets,
                                                                                losses)
    assert got.keys() == want.keys()
    for key in got:
        for c in range(5):
            np.testing.assert_array_equal(np.asarray(got[key][c], np.float64),
                                          np.asarray(want[key][c], np.float64))
    assert np.isnan(got["aucs"][2]) and np.isfinite(avg_auc(got))


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_tracker_eviction_semantics(tmp_path, impl):
    """Mirror of tests/test_train.py::test_tracker_eviction_semantics: both
    trackers evict the lowest-AUC record, reuse its file id, and save only
    if better; the port's files are .pt."""
    fn, ext = (update_tracker, ".pt") if impl == "port" else (jax_update_tracker, ".msgpack")
    out = str(tmp_path)
    os.makedirs(os.path.join(out, "best_checkpoints"))
    saved = []

    def save(path):
        saved.append(os.path.basename(path))
        open(path, "w").write("x")

    for i, aucv in enumerate([0.5, 0.7, 0.6]):
        fn(out, step=i, eval_loss=1.0, avg_auc=aucv, save_best=save, max_records=3)
    assert saved == [f"checkpoint_{i}{ext}" for i in range(3)]
    assert fn(out, step=3, eval_loss=1.0, avg_auc=0.4, save_best=save, max_records=3) is None
    assert len(saved) == 3
    fn(out, step=4, eval_loss=1.0, avg_auc=0.65, save_best=save, max_records=3)
    assert saved[-1] == f"checkpoint_0{ext}"
    data = np.atleast_2d(np.loadtxt(os.path.join(out, "checkpoints_tracker.csv"), skiprows=1))
    assert list(data[:, 3]) == sorted(data[:, 3], reverse=True)
    np.testing.assert_allclose(sorted(data[:, 3]), [0.6, 0.65, 0.7])


def test_config_round_trip_and_unported_fields(tmp_path):
    cfg = Config(train=True, model="aadensenet121", mini_data=7, lr=0.01, device="cpu")
    path = str(tmp_path / "config.json")
    cfg.save(path)
    assert Config.load(path) == cfg
    # one config.json serves both packages: the JAX Config ignores 'device'
    jcfg = JaxConfig.load(path)
    assert (jcfg.model, jcfg.mini_data, jcfg.lr) == ("aadensenet121", 7, 0.01)
    assert Config.from_dict(jcfg.to_dict()).replace(device="cpu") == cfg
    cfg.check_supported()
    # the multi-process fields run (slice 7); a bad layout fails in the Runner
    for field, value in (("multihost", True), ("data_parallel", 2), ("model_parallel", 2)):
        cfg.replace(**{field: value}).check_supported()
    for field, value, slice_ in (("packed_cache", True, 8), ("device_aug", True, 8),
                                 ("profile", True, 8)):
        with pytest.raises(NotImplementedError, match=f"slice {slice_}"):
            cfg.replace(**{field: value}).check_supported()
