"""The comparison that decides ``correct`` fails what it must: the control
(the reference in float8 in the program's place) and each fault a cell can
have, planted under the timed path, at sizes a CPU test run holds; and a
sound run passes, under SGD (tiny-wrn, tiny-dn) and under Adam (tiny-dna).
The limits here are the tiny cells' (harness_tree.py); the real cells'
limits come from readings on the card (PERF.md)."""

import pytest

from harness_tree import drive, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def test_sound_runs_pass(tree):
    for cell in ("tiny-wrn.train", "tiny-dna.train", "tiny-dn.serve"):
        r = drive(tree, cell, seed=3, seconds=1.0)
        assert r["correct"], (cell, r["checks"])


@pytest.mark.parametrize("cell", ["tiny-wrn.train", "tiny-dna.train", "tiny-dn.serve"])
def test_the_control_fails(tree, cell):
    r = drive(tree, cell, seed=4, seconds=1.0, control="fp8")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [("tiny-wrn.train", "unchanged"),
                                        ("tiny-wrn.train", "half_batch"),
                                        ("tiny-dn.train", "unchanged"),
                                        ("tiny-dn.train", "half_batch"),
                                        ("tiny-dna.train", "unchanged"),
                                        ("tiny-dna.train", "half_batch"),
                                        ("tiny-dn.serve", "altered")])
def test_each_fault_fails(tree, cell, fault):
    r = drive(tree, cell, seed=5, seconds=1.0, fault=fault)
    assert not r["correct"], r["checks"]
