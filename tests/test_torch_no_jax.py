"""The port imports no JAX: no module of chexpert_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax or the JAX package chexpert_tpu
(matched on the whole top-level name: chexpert_tpu_torch is allowed)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chexpert_tpu"}
FILES = sorted((ROOT / "chexpert_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chexpert_tpu_torch/cli/serve.py" in names
    assert "chexpert_tpu_torch/ops/fused_attention.py" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = sorted(set(_imported_top_levels(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_serve_import_leaves_jax_unloaded():
    code = ("import sys, chexpert_tpu_torch.cli.serve, chexpert_tpu_torch.models; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'chexpert_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]", out
