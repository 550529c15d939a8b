"""The port imports no JAX: no module of chexpert_tpu_torch/, not
chip_smoke.py and not the port's scripts (they run on the card host)
import jax, flax, optax or the JAX package chexpert_tpu
(matched on the whole top-level name: chexpert_tpu_torch is allowed), nor
pandas or scikit-learn, which the card host does not have."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chexpert_tpu", "pandas", "sklearn"}
SCRIPTS = ("profile_torch_serve.py", "profile_torch_train.py", "grad_divergence_torch.py",
           "route_noise_torch.py", "bench_attention_bwd_torch.py", "bench_attention_fwd_torch.py",
           "bench_depthwise_torch.py", "depthwise_ablation_torch.py", "ddp_scaling_torch.py",
           "multihost_ab_torch.py")
FILES = (sorted((ROOT / "chexpert_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + [ROOT / "scripts" / name for name in SCRIPTS])


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
    for module in ("cli/serve.py", "cli/chexpert.py", "ops/fused_attention.py",
                   "ops/depthwise.py", "models/efficientnet.py",
                   "configs/config.py", "data/chexpert.py", "data/pipeline.py",
                   "data/synthetic.py", "data/transforms.py", "eval/metrics.py",
                   "checkpoint/store.py", "checkpoint/tracker.py", "train/loop.py",
                   "train/optim.py", "train/steps.py", "utils/io.py", "utils/logging.py",
                   "cli/predict.py", "eval/ensemble.py", "interpret/gradcam.py",
                   "interpret/capture.py", "interpret/plots.py"):
        assert f"chexpert_tpu_torch/{module}" in names, module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = sorted(set(_imported_top_levels(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_serve_import_leaves_jax_unloaded():
    code = ("import sys, chexpert_tpu_torch.cli.serve, chexpert_tpu_torch.cli.chexpert, "
            "chexpert_tpu_torch.cli.predict, chexpert_tpu_torch.interpret, "
            "chexpert_tpu_torch.models; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{tuple(sorted(FORBIDDEN))}); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]", out
