"""Multi-process training and ensemble evaluation of the port on the CPU:
``python -m chexpert_tpu_torch.cli.chexpert --multihost`` as 2 gloo ranks
(torchrun's environment variables, ``--device cpu``), against one process
of the port and against the JAX CLI's single-process ``--data_parallel 2``
run on its virtual CPU mesh, all from the same initial weights (the JAX
init, carried into the port by ``state_dict_from_jax``).

aadensenet-tiny at 32x32, float32, global batch 8 (4 rows a rank), 24 train
images, 2 epochs = 6 steps at lr 1e-4 (SGD-Nesterov), eval and checkpoint
every 3 steps. Tolerances: losses and eval AUCs 1e-5 absolute; final
parameters and BatchNorm statistics 1e-5 absolute plus 1e-5 relative (the
first BatchNorm's running variance is ~240, where one float32 ulp is 1.5e-5);
the ensemble's metrics 1e-6 (the same forwards, summed over members in
another order). The ranks' global BatchNorm and DDP's gradient mean sum in
another order than one process does. The lr keeps those rounding
differences from growing past the bounds: on this fixture at lr 1e-2 two
one-process runs that differ only in their CPU thread count (1 or 4) part
by 5e-5 in the step-3 loss and 4e-4 in the step-6 loss, and at 1e-3 by
1e-4 in parameters after 6 steps.
"""

import json
import os
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_worker import launch
from chexpert_tpu.cli.chexpert import main as jax_main
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.train import init_model
from chexpert_tpu_torch.checkpoint import load_model_checkpoint, save_model_checkpoint
from chexpert_tpu_torch.cli.chexpert import main
from chexpert_tpu_torch.data import make_synthetic_dataset
from chexpert_tpu_torch.models import state_dict_from_jax

ARCH, SIZE = "aadensenet-tiny", 32
TOL = 1e-5
ENSEMBLE_TOL = 1e-6
CLI = ["-m", "chexpert_tpu_torch.cli.chexpert"]


def _common(data):
    return ["--data_path", data, "--model", ARCH, "--image_size", str(SIZE),
            "--batch_size", "8", "--lr", "1e-4", "--compute_dtype", "float32",
            "--data_workers", "2"]


def _train_args(data, out, init):
    return ["--train", "--evaluate_single_model", *_common(data), "--output_dir", out,
            "--n_epochs", "2", "--log_interval", "1", "--eval_interval", "3",
            "--device", "cpu", "--restore", init]


def _scalars(out):
    with open(os.path.join(out, "scalars.jsonl")) as f:
        return [r for r in map(json.loads, f) if "step" in r]


def _by_tag(out, prefix):
    return {(r["tag"], r["step"]): r["value"] for r in _scalars(out)
            if r["tag"].startswith(prefix)}


def _ok(results):
    for res in results:
        assert res.returncode == 0, res.stderr[-3000:]
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    data = str(root / "data")
    make_synthetic_dataset(data, n_train=24, n_valid=12, image_size=SIZE)
    jmodel, _ = jax_build_model(ARCH, image_size=SIZE, dtype=jnp.float32, attn_impl="einsum")
    params, stats = init_model(jmodel, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3))
    init = str(root / "init.pt")
    save_model_checkpoint(init, state_dict_from_jax(jax.device_get(params),
                                                    jax.device_get(stats)))
    dirs = {k: str(root / k) for k in ("one", "two", "jax")}
    main(_train_args(data, dirs["one"], init))
    two = _ok(launch(2, [*CLI, *_train_args(data, dirs["two"], init), "--multihost"],
                     str(root)))
    jax_main(["--train", *_common(data), "--output_dir", dirs["jax"], "--n_epochs", "2",
              "--log_interval", "1", "--eval_interval", "3", "--attn_impl", "einsum",
              "--data_parallel", "2"])
    return {"root": root, "data": data, "dirs": dirs, "two": two}


def test_two_ranks_follow_one_process_and_jax(runs):
    one, two, jx = (_by_tag(runs["dirs"][k], "") for k in ("one", "two", "jax"))
    losses = sorted(k for k in one if k[0] == "train_loss")
    assert [s for _, s in losses] == [1, 2, 3, 4, 5, 6]
    aucs = sorted(k for k in one if k[0].startswith("eval_auc_class_"))
    assert len(aucs) == 10  # 5 classes at steps 3 and 6
    for key in losses + aucs + [("eval_loss", 3), ("eval_loss", 6)]:
        np.testing.assert_allclose(two[key], one[key], atol=TOL, err_msg=str(key))
    # eval losses stay out: JAX keeps the biased running variance (ROADMAP C.1)
    for key in losses + aucs:
        np.testing.assert_allclose(two[key], jx[key], atol=TOL, err_msg=f"jax {key}")
    # images per second count the global batch: 8 images a step on 2 ranks
    assert {k[1] for k in two if k[0] == "images_per_sec"} == {1, 2, 3, 4, 5, 6}


def test_two_ranks_final_parameters_equal_one_process(runs):
    one, two = (load_model_checkpoint(os.path.join(runs["dirs"][k], "checkpoint_latest.pt"))
                for k in ("one", "two"))
    assert one["global_step"] == two["global_step"] == 6
    assert one["state_dict"].keys() == two["state_dict"].keys()
    assert not any(k.startswith("module.") for k in two["state_dict"])
    for key, want in one["state_dict"].items():
        np.testing.assert_allclose(two["state_dict"][key].numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=key)


def test_two_ranks_write_one_set_of_artifacts(runs):
    out = runs["dirs"]["two"]
    for name in ("config.json", "checkpoint_latest.pt", "optim_checkpoint_latest.pt",
                 "checkpoints_tracker.csv", "eval_results_step_3.json",
                 "eval_results_step_6.json"):
        assert os.path.exists(os.path.join(out, name)), name
    assert sorted(os.listdir(os.path.join(out, "best_checkpoints"))) == [
        "checkpoint_0.pt", "checkpoint_1.pt"]
    # the records of one process, each once (a second writer would double them)
    assert (Counter((r["tag"], r["step"]) for r in _scalars(out))
            == Counter((r["tag"], r["step"]) for r in _scalars(runs["dirs"]["one"])))
    with open(os.path.join(out, "scalars.jsonl")) as f:
        assert sum(1 for r in map(json.loads, f) if r["tag"] == "config") == 1
    assert len(Path(out, "checkpoints_tracker.csv").read_text().splitlines()) == 3
    assert [r.stdout.count("mesh {'data': 2, 'model': 1}, rank") for r in runs["two"]] == [1, 1]


def test_multihost_without_output_dir_raises(runs, tmp_path):
    argv = [*CLI, "--train", *_common(runs["data"]), "--device", "cpu", "--multihost"]
    for res in launch(2, argv, str(tmp_path)):
        assert res.returncode != 0
        assert "--multihost requires an explicit --output_dir" in res.stderr
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("layout", [["--data_parallel", "2"], ["--model_parallel", "2"]])
def test_two_rank_ensemble_equals_one_process(runs, tmp_path, layout):
    members = os.path.join(runs["dirs"]["one"], "best_checkpoints")
    argv = ["--evaluate_ensemble", *_common(runs["data"]), "--device", "cpu",
            "--restore", members]
    main([*argv, "--output_dir", str(tmp_path / "one")])
    _ok(launch(2, [*CLI, *argv, "--output_dir", str(tmp_path / "two"), "--multihost", *layout],
               str(tmp_path)))
    want, got = (json.loads((tmp_path / k / "eval_results_ensemble.json").read_text())
                 for k in ("one", "two"))
    assert got.keys() == want.keys()
    for key in want:
        for c in want[key]:
            np.testing.assert_allclose(got[key][c], want[key][c], atol=ENSEMBLE_TOL,
                                       err_msg=f"{key} {c}")
