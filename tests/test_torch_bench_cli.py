"""The port's CIFAR bench CLI (chexpert_tpu_torch/cli/bench.py) against the
JAX package's, on the CPU: the JAX test's single-batch overfit with
evaluation and attention maps, the data helpers draw for draw, top-k
accuracy, the restore of model and optimizer, and the guards."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chexpert_tpu.cli import bench as jax_bench
from chexpert_tpu_torch.cli import bench

RUN = ["densenet", "8", "10", "--attn", "--attn_nh", "2", "--attn_k", "0.25", "--attn_v", "0.25",
       "--train", "--synthetic", "--mini_data", "--dataset", "cifar10",
       "--batch_size", "32", "--lr", "0.05", "--log_interval", "1",
       "--compute_dtype", "float32", "--device", "cpu"]


def _scalars(out, tag):
    with open(os.path.join(out, "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r.get("tag") == tag]


@pytest.fixture(scope="module")
def overfit(tmp_path_factory):
    """The JAX test's run (densenet 8 10 --attn, 12 epochs of one batch), with
    --evaluate and --vis_attn."""
    out = str(tmp_path_factory.mktemp("bench") / "run")
    assert bench.main(RUN + ["--n_epochs", "12", "--eval_interval", "100", "--evaluate",
                             "--vis_attn", "--output_dir", out]) == 0
    return out


def test_overfit_writes_the_jax_artifacts(overfit):
    losses = _scalars(overfit, "train_loss")
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert _scalars(overfit, "lr")[0] == 0.0  # linear warmup: LR 0 at step 0
    for tag in ("eval_loss", "acc@top1", "acc@top5"):
        assert len(_scalars(overfit, tag)) == 1
    for name in ("checkpoint.pt", "optim_checkpoint.pt", "config.json"):
        assert os.path.exists(os.path.join(overfit, name))
    vis = os.listdir(os.path.join(overfit, "vis"))
    assert any(v.startswith("attn_image") for v in vis)


def test_restore_continues_the_step_and_the_optimizer(overfit, tmp_path):
    """One more epoch from the run's checkpoint.pt and optim_checkpoint.pt
    gives step 13 the loss of a straight 13-epoch run: the model, the
    momentum and the scheduler's count all come back."""
    out, straight = str(tmp_path / "again"), str(tmp_path / "straight")
    assert bench.main(RUN + ["--n_epochs", "1", "--output_dir", out, "--restore",
                             os.path.join(overfit, "checkpoint.pt")]) == 0
    with open(os.path.join(out, "scalars.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if r.get("tag") == "train_loss"]
    assert steps == [13]
    assert bench.main(RUN + ["--n_epochs", "13", "--eval_interval", "100",
                             "--output_dir", straight]) == 0
    assert _scalars(out, "train_loss")[0] == pytest.approx(_scalars(straight, "train_loss")[12],
                                                           abs=1e-6)


@pytest.mark.parametrize("n_classes", [10, 100])
def test_synthetic_augment_normalize_equal_jax(n_classes):
    got = bench.synthetic_cifar(n_classes, n_train=40, n_test=12, seed=3)
    want = jax_bench.synthetic_cifar(n_classes, n_train=40, n_test=12, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    a = bench.augment(got[0], np.random.RandomState(5))
    np.testing.assert_array_equal(a, jax_bench.augment(want[0], np.random.RandomState(5)))
    np.testing.assert_array_equal(bench.normalize(a), jax_bench.normalize(a))


def _augment_pad_and_loop(x_uint8, rng):
    """``augment`` as first written: ``np.pad``, then a crop and flip one
    image at a time."""
    n = len(x_uint8)
    padded = np.pad(x_uint8, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(x_uint8)
    tops = rng.randint(0, 9, n)
    lefts = rng.randint(0, 9, n)
    flips = rng.rand(n) < 0.5
    for i in range(n):
        img = padded[i, tops[i]:tops[i] + 32, lefts[i]:lefts[i] + 32]
        out[i] = img[:, ::-1] if flips[i] else img
    return out


@pytest.mark.parametrize("n,seed", [(1, 0), (3, 7), (256, 11), (256, 4294967295)])
def test_augment_equals_pad_and_loop(n, seed):
    """The one-gather ``augment`` gives the pad-and-loop output bit for bit and
    leaves the rng where it left it; the batch of 256 holds flipped images
    and crops at both extreme offsets."""
    x = np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    rng_got, rng_want = np.random.RandomState(seed), np.random.RandomState(seed)
    got = bench.augment(x, rng_got)
    want = _augment_pad_and_loop(x, rng_want)
    assert got.dtype == np.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    assert rng_got.rand() == rng_want.rand()
    if n == 256:
        draws = np.random.RandomState(seed)
        offsets = np.concatenate([draws.randint(0, 9, n), draws.randint(0, 9, n)])
        assert (draws.rand(n) < 0.5).any() and {0, 8} <= set(offsets.tolist())


@pytest.mark.parametrize("layout", ["nhwc", "nchw_storage"])
def test_to_device_equals_normalize_then_permute(layout):
    """``to_device`` whitens on the device what ``normalize`` whitens on the
    host, bit for bit, into contiguous NCHW f32; also from a batch that is an
    NHWC view of NCHW storage, as ``load_cifar`` returns."""
    x = np.random.RandomState(3).randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    if layout == "nchw_storage":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    got = bench.to_device(x, torch.device("cpu"))
    want = torch.from_numpy(bench.normalize(x)).permute(0, 3, 1, 2).contiguous()
    assert got.dtype == torch.float32 and got.shape == (6, 3, 32, 32)
    assert got.is_contiguous() and got.stride() == want.stride()
    assert torch.equal(got, want)


def test_topk_accuracy_equals_jax():
    rng = np.random.RandomState(0)
    logits, y = rng.randn(50, 10).astype(np.float32), rng.randint(0, 10, 50)
    assert bench.topk_accuracy(logits, y) == jax_bench.topk_accuracy(logits, y)
    assert bench.topk_accuracy(logits, y, ks=(1, 3)) == jax_bench.topk_accuracy(logits, y,
                                                                               ks=(1, 3))


def test_parser_matches_jax():
    """The JAX subcommands, flags and defaults, plus --device (default cuda)."""
    for argv in (["efficientnet", "b0"], ["resnet", "50"], ["wideresnet", "28", "10"],
                 ["densenet", "12", "100", "--attn"]):
        got = vars(bench.build_parser().parse_args(argv))
        want = vars(jax_bench.build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want


@pytest.mark.parametrize("argv,exc,match", [
    (["--data_parallel", "2"], AssertionError, "mesh 2x1 needs 2 devices, have 1"),
    (["--vis_attn"], AssertionError, "Enable --attn"),
])
def test_guards_raise(tmp_path, argv, exc, match):
    run = [a for a in RUN if a != "--attn"] if "--vis_attn" in argv else RUN
    with pytest.raises(exc, match=match):
        bench.main(run + ["--n_epochs", "1", "--output_dir", str(tmp_path / "x"), *argv])


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["efficientnet", "b0", "--synthetic", "--output_dir", str(tmp_path)])


def test_package_main_prints_the_entry_points():
    out = subprocess.run([sys.executable, "-m", "chexpert_tpu_torch"], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    for entry in ("cli.chexpert", "cli.predict", "cli.bench", "cli.serve", "cli.data_tools"):
        assert f"python -m chexpert_tpu_torch.{entry}" in out
