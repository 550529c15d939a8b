"""The port's predict CLI (cli/predict.py) against the JAX package's, on the
CPU, in float32, on the synthetic fixture with two views per study (so the
max over a study's views matters).

Two densenet-tiny checkpoints (numpy draws into the JAX trees) are written
as the JAX package's checkpoint_<k>.msgpack and, through
``state_dict_from_jax``, as the port's checkpoint_<k>.pt. Each CLI predicts
a test csv of the valid images' absolute paths, for one checkpoint and for
the directory, and writes its csv (the JAX one with pandas, the port's with
the ``csv`` module).

Tolerance: values 1e-5 absolute (sigmoid probabilities of the same f32
forward); header and study order exactly.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.checkpoint import save_model_checkpoint as jax_save
from chexpert_tpu.cli.predict import main as jax_predict
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu_torch.checkpoint import save_model_checkpoint
from chexpert_tpu_torch.cli.predict import main as port_predict
from chexpert_tpu_torch.data import DIR_NAME, make_synthetic_dataset
from chexpert_tpu_torch.data.chexpert import read_csv, write_csv
from chexpert_tpu_torch.models import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
ARCH, SIZE, K = "densenet-tiny", 32, 2
HEADER = ["Study", "Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Pleural Effusion"]


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
def work(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("predict"))
    make_synthetic_dataset(root, n_train=8, n_valid=12, image_size=SIZE, views_per_study=2)
    jmodel, _ = jax_build_model(ARCH, image_size=SIZE, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    dirs = {"jax": os.path.join(root, "jax"), "port": os.path.join(root, "port")}
    for d in dirs.values():
        os.makedirs(d)
    for k in range(K):
        rng = np.random.RandomState(k)
        params = _random_tree(shapes["params"], rng)
        stats = _random_tree(shapes["batch_stats"], rng)
        jax_save(os.path.join(dirs["jax"], f"checkpoint_{k}.msgpack"), params, stats, k, 1.0, 0.5)
        save_model_checkpoint(os.path.join(dirs["port"], f"checkpoint_{k}.pt"),
                              state_dict_from_jax(params, stats, ARCH), k, 1.0, 0.5)
    # test csvs of the valid images' absolute paths: every column, and Path alone
    header, rows = read_csv(os.path.join(root, DIR_NAME, "valid.csv"))
    rows = [[os.path.join(root, r[0]), *r[1:]] for r in rows]
    full, paths_only = os.path.join(root, "test_full.csv"), os.path.join(root, "test_paths.csv")
    write_csv(full, header, rows)
    write_csv(paths_only, ["Path"], [[r[0]] for r in rows])
    return {"root": root, "dirs": dirs, "full": full, "paths_only": paths_only}


def _args(test_csv, out_csv, restore, *extra):
    return [test_csv, out_csv, "--restore_path", restore, "--model", ARCH,
            "--image_size", str(SIZE), "--batch_size", "8", "--compute_dtype", "float32",
            "--data_workers", "2", *extra]


def _run(work, which, test_csv, restore_name, *extra):
    restore = os.path.join(work["dirs"][which], restore_name)
    if which == "jax":
        restore = restore.replace(".pt", ".msgpack")
    out = os.path.join(work["root"], f"{which}_{restore_name}_{os.path.basename(test_csv)}")
    if which == "jax":
        assert jax_predict(_args(test_csv, out, restore, *extra)) == 0
    else:
        assert port_predict(_args(test_csv, out, restore, "--device", "cpu", *extra)) == 0
    with open(out, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("restore", ["checkpoint_1.pt", ""], ids=["checkpoint", "directory"])
@pytest.mark.parametrize("test_csv", ["full", "paths_only"])
def test_predict_csv_equals_jax(work, restore, test_csv):
    got = _run(work, "port", work[test_csv], restore)
    want = _run(work, "jax", work[test_csv], restore)
    assert got[0] == want[0] == HEADER
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]]
    assert len(got) - 1 == 6 and [r[0] for r in got[1:]] == sorted(r[0] for r in got[1:])
    g = np.array([r[1:] for r in got[1:]], np.float64)
    np.testing.assert_allclose(g, np.array([r[1:] for r in want[1:]], np.float64), atol=1e-5)
    assert ((g >= 0) & (g <= 1)).all()


def test_directory_is_the_mean_of_its_checkpoints(work):
    runs = [_run(work, "port", work["full"], f"checkpoint_{k}.pt") for k in range(K)]
    ens = _run(work, "port", work["full"], "")
    vals = [np.array([r[1:] for r in run[1:]], np.float64) for run in runs]
    np.testing.assert_allclose(np.array([r[1:] for r in ens[1:]], np.float64),
                               np.mean(vals, axis=0), atol=1e-6)  # the mean is kept in f32


def _aucs(text):
    body = text.split("AUC:\n", 1)[1].strip().splitlines()[0]
    return eval(body, {"nan": float("nan")})


def test_debug_prints_the_jax_aucs(work, capsys, monkeypatch):
    monkeypatch.setenv("CHEXPERT_TPU_DATA_DIR", work["root"])
    _run(work, "port", work["full"], "", "--debug")
    ours = capsys.readouterr().out
    _run(work, "jax", work["full"], "", "--debug")
    theirs = capsys.readouterr().out
    assert "Metrics for predictions vs targets" in ours
    a, b = _aucs(ours), _aucs(theirs)
    assert a.keys() == b.keys() == set(range(5))
    np.testing.assert_allclose([a[c] for c in range(5)], [b[c] for c in range(5)], atol=1e-12)
    # --valid_data_path names the valid root instead of the variable
    monkeypatch.delenv("CHEXPERT_TPU_DATA_DIR")
    _run(work, "port", work["full"], "checkpoint_0.pt", "--debug", "--valid_data_path",
         work["root"])
    assert _aucs(capsys.readouterr().out).keys() == set(range(5))


def test_data_parallel_raises_naming_slice_7(work):
    """Multi-process training (ROADMAP.md slice 7) ported --data_parallel:
    the one device a process drives runs a mesh of 1, and a larger one
    raises the JAX create_mesh assertion, before any csv is written."""
    out = os.path.join(work["root"], "x.csv")
    with pytest.raises(AssertionError, match="mesh 2x1 needs 2 devices, have 1"):
        port_predict(_args(work["full"], out, work["dirs"]["port"], "--device", "cpu",
                           "--data_parallel", "2"))
    assert not os.path.exists(out)


def test_default_device_is_cuda_and_raises_without_a_card(work, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = tmp_path / "out.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "chexpert_tpu_torch.cli.predict", work["full"], str(out),
         "--restore_path", work["dirs"]["port"], "--model", ARCH],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not out.exists()
