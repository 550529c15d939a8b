"""The port's data tools CLI (chexpert_tpu_torch/cli/data_tools.py),
``compute_mean_and_std`` and the dataset download's local branches against
the JAX package's, on the CPU, on the synthetic fixture: the same printed
lines, PNG pixels and report files. The URL is never reached:
``urllib.request.urlretrieve`` raises in every test here."""

import os
import shutil
import urllib.request
import zipfile

import numpy as np
import pytest
from PIL import Image

from chexpert_tpu.cli import data_tools as jax_tools
from chexpert_tpu.data.chexpert import _maybe_download_and_extract as jax_download
from chexpert_tpu.data.chexpert import compute_mean_and_std as jax_mean_std
from chexpert_tpu_torch.cli import data_tools
from chexpert_tpu_torch.data import ChexpertIndex, compute_mean_and_std, make_synthetic_dataset
from chexpert_tpu_torch.data.chexpert import DIR_NAME, _maybe_download_and_extract

SIZE = 32


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("the dataset URL must not be reached")

    monkeypatch.setattr(urllib.request, "urlretrieve", refused)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools"))
    make_synthetic_dataset(root, n_train=12, n_valid=6, image_size=SIZE)
    return root


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_stats_prints_the_jax_mean_and_std(data, capsys):
    argv = ["stats", data, "--image_size", str(SIZE), "--limit", "9"]
    got, want = _run(data_tools.main, argv, capsys), _run(jax_tools.main, argv, capsys)
    assert "Dataset mean:" in got and got == want


def test_compute_mean_and_std_equals_jax():
    images = [np.random.RandomState(i).rand(4, 5) for i in range(7)]
    assert compute_mean_and_std(iter(images)) == jax_mean_std(iter(images))


def test_inspect_writes_the_jax_images_and_labels(data, tmp_path, capsys):
    outs = [str(tmp_path / "ours"), str(tmp_path / "jax")]
    printed = [_run(main, ["inspect", data, "--image_size", str(SIZE), "--n", "4", "--out", o],
                    capsys) for main, o in zip((data_tools.main, jax_tools.main), outs)]
    assert printed[0].replace(outs[0], "OUT") == printed[1].replace(outs[1], "OUT")
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1])) and len(names) == 4
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(outs[0], n))),
                                      np.asarray(Image.open(os.path.join(outs[1], n))))


def test_explore_writes_the_jax_report(data, tmp_path, capsys):
    outs = [str(tmp_path / "ours"), str(tmp_path / "jax")]
    for main, o in zip((data_tools.main, jax_tools.main), outs):
        _run(main, ["explore", data, "--out", o], capsys)
    for name in ("explore.md", "cooccurrence.csv"):
        with open(os.path.join(outs[0], name)) as a, open(os.path.join(outs[1], name)) as b:
            assert a.read() == b.read(), name


def test_download_skipped_when_the_dataset_is_there(data):
    before = sorted(os.listdir(data))
    _maybe_download_and_extract(data)
    assert sorted(os.listdir(data)) == before
    assert len(ChexpertIndex(data, "train")) == 12  # the default download=True


def test_a_zip_beside_the_root_is_extracted_without_a_download(data, tmp_path):
    roots = []
    for name, fn in (("ours", _maybe_download_and_extract), ("jax", jax_download)):
        root = tmp_path / name
        root.mkdir()
        with zipfile.ZipFile(root / f"{DIR_NAME}.zip", "w") as z:
            for d, _, files in os.walk(os.path.join(data, DIR_NAME)):
                for f in files:
                    if ".processed" not in f:
                        full = os.path.join(d, f)
                        z.write(full, os.path.relpath(full, data))
        fn(str(root))
        assert not (root / f"{DIR_NAME}.zip").exists()  # the zip is removed
        roots.append(root)
    listing = [sorted(p.relative_to(r).as_posix() for p in r.rglob("*")) for r in roots]
    assert listing[0] == listing[1] and f"{DIR_NAME}/train.csv" in listing[0]
    shutil.rmtree(roots[0] / DIR_NAME)
    with zipfile.ZipFile(roots[0] / f"{DIR_NAME}.zip", "w") as z:
        z.write(os.path.join(data, DIR_NAME, "train.csv"), f"{DIR_NAME}/train.csv")
        z.write(os.path.join(data, DIR_NAME, "valid.csv"), f"{DIR_NAME}/valid.csv")
    assert len(ChexpertIndex(str(roots[0]), "train")) == 12  # extracted by the index itself
