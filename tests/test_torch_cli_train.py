"""The port's training CLI (``chexpert_tpu_torch.cli.chexpert``) on the CPU,
on the synthetic fixture: artifacts, resume, config overlay, and the
device / ensemble / visualize / plot_roc / not-ported guards."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chexpert_tpu_torch.checkpoint import load_model_checkpoint
from chexpert_tpu_torch.cli.chexpert import main
from chexpert_tpu_torch.data import make_synthetic_dataset

ROOT = Path(__file__).resolve().parent.parent


def _args(data, out, *extra):
    return ["--data_path", data, "--output_dir", out, "--model", "aadensenet-tiny",
            "--image_size", "32", "--batch_size", "8", "--lr", "1e-2",
            "--compute_dtype", "float32", "--data_workers", "2", "--device", "cpu", *extra]


def _steps(out, tag):
    with open(os.path.join(out, "scalars.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r.get("tag") == tag]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One training run: 24 train images, batch 8, 2 epochs = 6 steps, inline
    eval + checkpoint every 4 steps."""
    data = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(data, n_train=24, n_valid=12, image_size=32)
    out = os.path.join(data, "run1")
    main(["--train", "--evaluate_single_model", *_args(data, out), "--n_epochs", "2",
          "--log_interval", "2", "--eval_interval", "4"])
    return data, out


def test_train_writes_the_run_artifacts(run):
    _, out = run
    for name in ("config.json", "scalars.jsonl", "checkpoint_latest.pt",
                 "optim_checkpoint_latest.pt", "checkpoints_tracker.csv",
                 "eval_results_step_3.json", "eval_results_step_6.json",
                 os.path.join("best_checkpoints", "checkpoint_0.pt")):
        assert os.path.exists(os.path.join(out, name)), name
    assert _steps(out, "train_loss") == [2, 4, 6]
    losses = [r["value"] for r in map(json.loads, open(os.path.join(out, "scalars.jsonl")))
              if r.get("tag") == "train_loss"]
    assert np.isfinite(losses).all()
    ck = load_model_checkpoint(os.path.join(out, "checkpoint_latest.pt"))
    assert ck["global_step"] == 4 and np.isfinite(ck["avg_auc"])
    metrics = json.load(open(os.path.join(out, "eval_results_step_6.json")))
    assert set(metrics) == {"fpr", "tpr", "aucs", "precision", "recall", "loss"}
    assert json.load(open(os.path.join(out, "config.json")))["device"] == "cpu"


def test_restore_continues_the_step_counter(run):
    data, out = run
    main(["--train", *_args(data, out), "--restore", os.path.join(out, "checkpoint_latest.pt"),
          "--n_epochs", "1", "--log_interval", "1", "--eval_interval", "0"])
    # restored at step 4 (the last inline checkpoint) with its optimizer state
    assert _steps(out, "train_loss")[-3:] == [5, 6, 7]
    assert os.path.exists(os.path.join(out, "eval_results_step_7.json"))


def test_evaluate_restored_checkpoint_and_auto_resume(run, tmp_path):
    data, out = run
    out2 = str(tmp_path / "eval")
    ck = os.path.join(out, "best_checkpoints", "checkpoint_0.pt")
    main(["--evaluate_single_model", *_args(data, out2), "--restore", ck])
    step = load_model_checkpoint(ck)["global_step"]
    assert os.path.exists(os.path.join(out2, f"eval_results_step_{step}.json"))
    # --auto_resume picks up output_dir/checkpoint_latest.pt without --restore
    out3 = str(tmp_path / "resume")
    main(["--train", *_args(data, out3), "--n_epochs", "1", "--eval_interval", "3"])
    main(["--train", *_args(data, out3), "--n_epochs", "1", "--eval_interval", "0",
          "--auto_resume", "--log_interval", "1"])
    assert _steps(out3, "train_loss")[-3:] == [4, 5, 6]


def test_load_config_overlay(run, tmp_path):
    data, _ = run
    cfg = tmp_path / "overlay.json"
    cfg.write_text(json.dumps({"mini_data": 8, "n_epochs": 1, "log_interval": 1}))
    out = str(tmp_path / "overlay")
    main(["--train", *_args(data, out), "--load_config", str(cfg), "--eval_interval", "0"])
    assert _steps(out, "train_loss") == [1]  # 8 images, batch 8
    assert json.load(open(os.path.join(out, "config.json")))["mini_data"] == 8


@pytest.mark.parametrize("case", ["ensemble_restore_is_a_file", "ensemble_empty_directory",
                                  "plot_roc_without_results", "visualize_without_attention"])
def test_ensemble_visualize_and_plot_roc_guards(run, tmp_path, case):
    """The JAX CLI's guards (chexpert_tpu/cli/chexpert.py): --evaluate_ensemble
    wants a directory of checkpoints and fails on an empty one; --plot_roc
    with no eval_results*.json raises RuntimeError; --visualize on a model
    without attention writes the Grad-CAM grids and no attention map."""
    data, out = run
    new = str(tmp_path / "x")
    if case == "ensemble_restore_is_a_file":
        with pytest.raises(AssertionError, match="must be directory"):
            main(["--evaluate_ensemble", *_args(data, new), "--restore",
                  os.path.join(out, "checkpoint_latest.pt")])
    elif case == "ensemble_empty_directory":
        (tmp_path / "empty").mkdir()
        with pytest.raises(AssertionError, match="no checkpoints found"):
            main(["--evaluate_ensemble", *_args(data, new), "--restore", str(tmp_path / "empty")])
    elif case == "plot_roc_without_results":
        with pytest.raises(RuntimeError, match="No `eval_results` files found"):
            main(["--plot_roc", *_args(data, new)])
    else:
        main(["--visualize", *_args(data, new), "--model", "densenet-tiny"])
        vis = sorted(os.listdir(os.path.join(new, "vis")))
        assert len(vis) == 8 and all(v.startswith("vis_") and v.endswith("_step_0.png")
                                     for v in vis)


@pytest.mark.parametrize("flags,exc,match", [
    (["--multihost", "--data_parallel", "2"], AssertionError,
     "mesh 2x1 needs 2 devices, have 1"),
    (["--packed_cache"], NotImplementedError, "slice 8"),
    (["--pretrained"], NotImplementedError, "slice 8"),
])
def test_unported_and_bad_flags_raise(run, tmp_path, flags, exc, match):
    data, _ = run
    with pytest.raises(exc, match=match):
        main(["--train", *_args(data, str(tmp_path / "x")), *flags])


@pytest.mark.parametrize("target", ["missing.pt", "a_directory"])
def test_restore_that_is_not_a_file_is_skipped_as_in_jax(run, tmp_path, capsys, target):
    """A --restore that is not a file starts from scratch and says so: the
    JAX Runner (chexpert_tpu/cli/chexpert.py) skips such a restore too."""
    from chexpert_tpu.cli.chexpert import Runner as JaxRunner
    from chexpert_tpu.cli.chexpert import config_from_args as jax_config

    data, _ = run
    path = tmp_path / target
    if target == "a_directory":
        path.mkdir()
    jax_runner = JaxRunner(jax_config([
        "--train", "--data_path", data, "--output_dir", str(tmp_path / "jax"), "--model",
        "aadensenet-tiny", "--image_size", "32", "--batch_size", "8", "--compute_dtype",
        "float32", "--restore", str(path)]))
    assert jax_runner.start_step == 0
    out = str(tmp_path / "port")
    main(["--train", *_args(data, out), "--restore", str(path), "--n_epochs", "1",
          "--log_interval", "1", "--eval_interval", "0"])
    assert f"Not restoring: --restore {str(path)!r}" in capsys.readouterr().out
    assert _steps(out, "train_loss") == [1, 2, 3]  # 24 images, batch 8, from step 0


def test_default_device_is_cuda_and_raises_without_a_card(tmp_path):
    """Without --device the CLI asks for the card; on a host without one it
    exits with the error before writing anything, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "chexpert_tpu_torch.cli.chexpert", "--train",
         "--data_path", str(tmp_path), "--output_dir", str(out), "--model", "densenet-tiny"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not out.exists()
