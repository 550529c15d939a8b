"""The port's --evaluate_ensemble, --plot_roc and --visualize through
``cli.chexpert.main --device cpu`` against the JAX CLI's, on the synthetic
fixture (12 valid images at 32x32, aadensenet-tiny, float32, on the einsum
attention route: the kernels' routes are held elsewhere, and the JAX
package's Pallas interpret mode would triple the time).

Three seeded models are saved by the port's checkpoint store as a run
directory (best_checkpoints/checkpoint_<k>.pt, checkpoint_latest.pt at step
5); the JAX CLI reads the same .pt files through its torch interop. Both
CLIs write the same file names (eval_results_ensemble.json, plots/roc_pr_*,
vis/vis_*_step_5.png, vis/attn_image_idx_*_layer_0.png); the PNGs are held
by existence and non-zero size only. The ensemble's AUCs and losses agree
within 1e-5.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from chexpert_tpu_torch.checkpoint import save_model_checkpoint
from chexpert_tpu_torch.cli.chexpert import main
from chexpert_tpu_torch.data import make_synthetic_dataset
from chexpert_tpu_torch.interpret import plot_roc
from chexpert_tpu_torch.models import build_model

ARCH = "aadensenet-tiny"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("interpret"))
    make_synthetic_dataset(root, n_train=8, n_valid=12, image_size=32)
    run = os.path.join(root, "run")
    os.makedirs(os.path.join(run, "best_checkpoints"))
    for k in range(3):
        sd = build_model(ARCH, image_size=32, generator=torch.Generator().manual_seed(k)
                         ).state_dict()
        save_model_checkpoint(os.path.join(run, "best_checkpoints", f"checkpoint_{k}.pt"), sd, k)
        if k == 0:
            save_model_checkpoint(os.path.join(run, "checkpoint_latest.pt"), sd, 5)
    return root, run


def _drive(work, which):
    root, run = work
    out = os.path.join(root, which)
    args = ["--data_path", root, "--output_dir", out, "--model", ARCH, "--image_size", "32",
            "--batch_size", "8", "--compute_dtype", "float32", "--data_workers", "2",
            "--attn_impl", "einsum"]
    if which == "jax":
        from chexpert_tpu.cli.chexpert import main as drive
    else:
        drive, args = main, args + ["--device", "cpu"]
    assert drive(["--evaluate_ensemble", "--plot_roc", *args, "--restore",
                  os.path.join(run, "best_checkpoints")]) == 0
    assert drive(["--visualize", *args, "--restore",
                  os.path.join(run, "checkpoint_latest.pt")]) == 0
    return out


def _files(out, sub):
    return sorted(os.listdir(os.path.join(out, sub)))


def test_ensemble_plot_roc_and_visualize_write_the_jax_files(work):
    ours, theirs = _drive(work, "port"), _drive(work, "jax")
    for sub in ("plots", "vis"):
        assert _files(ours, sub) == _files(theirs, sub), sub
    assert _files(ours, "plots") == ["roc_pr_eval_results_ensemble.png"]
    vis = _files(ours, "vis")
    assert sum(v.startswith("vis_") and v.endswith("_step_5.png") for v in vis) == 8
    assert any(v.startswith("attn_image_idx_") and v.endswith("_layer_0.png") for v in vis)
    for sub in ("plots", "vis"):
        for name in _files(ours, sub):
            assert os.path.getsize(os.path.join(ours, sub, name)) > 0, name
    got, want = (json.load(open(os.path.join(d, "eval_results_ensemble.json")))
                 for d in (ours, theirs))
    assert set(got) == set(want)
    for c in map(str, range(5)):
        np.testing.assert_allclose(got["aucs"][c], want["aucs"][c], atol=1e-5)
        np.testing.assert_allclose(got["loss"][c], want["loss"][c], atol=1e-5)


def test_plots_without_matplotlib_raise_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    metrics = {"fpr": {}, "tpr": {}, "aucs": {}, "precision": {}, "recall": {}}
    with pytest.raises(ImportError, match="matplotlib"):
        plot_roc(metrics, str(tmp_path), "roc_pr_x")


def test_importing_the_port_leaves_matplotlib_unloaded():
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys, chexpert_tpu_torch.cli.chexpert, chexpert_tpu_torch.cli.predict, "
            "chexpert_tpu_torch.interpret; print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
                         text=True).stdout
    assert out.strip() == "False"
