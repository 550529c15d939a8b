"""The harness finds a cell's configuration, traffic mix, limits and
per-layer readers by name: a new cell and a new metric need new files only,
no edit to a file that is there."""

import hashlib
import json
from pathlib import Path

import pytest

from harness_tree import BENCH, drive, make_tree


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def test_a_new_cell_and_metric_are_files_only(tree):
    before = digest(tree / "benchmark")
    # a new per-layer metric: a reader of its own, found by its name
    (tree / "benchmark" / "metrics" / "train.steps_seen.py").write_text(
        "def read(record):\n    return float(record.counters.get('window_steps', 0)) or None\n")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "train.steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "cifar_img_per_s", "workloads": ["tiny-wrn.train"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tree / "benchmark")
    assert {k: v for k, v in before.items() if after.get(k) != v} == {}
    result = drive(tree, "tiny-wrn.train", seed=2 ** 31 + 5, seconds=1.0, trace=1)
    assert result["metrics"]["train.steps_seen"]["value"] >= 1
    assert result["metrics"]["step.host_ms.cifar"]["value"] > 0
    assert result["correct"], result["checks"]


def test_the_tiny_cells_are_files_only(tree):
    # make_tree added configs, traffic mixes and limits beside the real ones
    # and changed none of the files it copied
    copied = digest(tree / "benchmark")
    original = digest(BENCH)
    assert {k for k in original if copied.get(k) != original[k]} == set()
    for name in ("configs/tiny-dn.json", "traffic/tiny_serve.json", "limits/tiny-dn.serve.json"):
        assert name in copied


def test_the_chexpert_cell_runs_from_files(tree):
    # its per-layer metrics share the training readers by the name before
    # the cell's suffix (metrics/step.host_ms.py serves step.host_ms.chexpert)
    result = drive(tree, "tiny-dn.train", seed=2 ** 31 + 9, seconds=1.0, trace=1)
    for m in ("input.wait_ms.chexpert", "step.host_ms.chexpert"):
        assert result["metrics"][m]["value"] > 0, m
    assert not (BENCH / "metrics" / "step.host_ms.chexpert.py").exists()


def test_the_serving_cell_runs_from_files(tree):
    result = drive(tree, "tiny-dn.serve", seed=11, seconds=2.0, trace=1)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 8 and result["failed"] == 0
    for m in ("serve.http_ms", "serve.queue_ms", "serve.preprocess_ms", "serve.forward_ms"):
        assert result["metrics"][m]["value"] >= 0, m
