"""The port's packed cache, device crop and input prep against the JAX
package's, on the CPU: caches byte-equal and each read by the other package,
equal batches for the same seed and epoch (rank slices included), the
pack's lock, stale-lock break and resume, ``crop_and_flip`` on JAX's draws
against JAX's ``device_augment``, ``prepare_image``, and the CLI's
--packed_cache, --device_aug and --profile runs. Everything here is exact:
the same uint8 bytes and the same numpy draws."""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chexpert_tpu.data.packed as jax_packed
import chexpert_tpu_torch.data.packed as packed
from chexpert_tpu.data import ChexpertIndex as JaxIndex
from chexpert_tpu.train.steps import device_augment as jax_device_augment
from chexpert_tpu.train.steps import prepare_image as jax_prepare_image
from chexpert_tpu_torch.cli.chexpert import main
from chexpert_tpu_torch.data import ChexpertIndex, make_synthetic_dataset
from chexpert_tpu_torch.train import crop_and_flip, device_augment, prepare_image
from chexpert_tpu_torch.utils import trace as tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 40


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("packed"))
    make_synthetic_dataset(root, n_train=20, n_valid=10, image_size=48)
    return root


def _files(path):
    with open(path, "rb") as f, open(path + ".json", "rb") as g:
        return f.read(), g.read()


@pytest.mark.parametrize("mode,resize,margin", [("train", None, 8), ("valid", None, 8),
                                                ("train", 20, 4)])
def test_caches_byte_equal_and_read_by_either_package(data, tmp_path, monkeypatch, mode, resize,
                                                      margin):
    size = resize or SIZE
    ours = packed.build_packed_cache(ChexpertIndex(data, mode, download=False),
                                     str(tmp_path / "a"), image_size=size, resize=resize,
                                     workers=2, pack_margin=margin)
    jax_index = JaxIndex(data, mode, download=False)
    theirs = jax_packed.build_packed_cache(jax_index, str(tmp_path / "b"), image_size=size,
                                           resize=resize, workers=2, pack_margin=margin)
    assert os.path.basename(ours) == os.path.basename(theirs)
    assert _files(ours) == _files(theirs)

    def no_decode(*a, **kw):
        raise AssertionError("a valid cache was packed again")
    # each package takes the other's cache as it is
    monkeypatch.setattr(jax_packed, "load_grayscale", no_decode)
    monkeypatch.setattr(packed, "load_grayscale", no_decode)
    assert jax_packed.build_packed_cache(jax_index, str(tmp_path / "a"), image_size=size,
                                         resize=resize, pack_margin=margin) == ours
    assert packed.build_packed_cache(ChexpertIndex(data, mode, download=False),
                                     str(tmp_path / "b"), image_size=size, resize=resize,
                                     pack_margin=margin) == theirs


@pytest.mark.parametrize("shuffle,augment,emit_stored,drop_last", [
    (False, False, False, False), (True, True, False, True), (True, False, True, True),
    (False, True, False, False)])
@pytest.mark.parametrize("host_slice", [None, slice(0, 4), slice(4, 8)])
def test_packed_batches_equal_jax(data, tmp_path, shuffle, augment, emit_stored, drop_last,
                                  host_slice):
    index = ChexpertIndex(data, "train", download=False)
    path = packed.build_packed_cache(index, str(tmp_path), image_size=SIZE, pack_margin=8)
    kw = dict(image_size=SIZE, shuffle=shuffle, augment=augment, emit_stored=emit_stored,
              drop_last=drop_last, seed=3, epoch=2, host_slice=host_slice)
    ours = list(packed.PackedBatches(index, path, 8, **kw))
    theirs = list(jax_packed.PackedBatches(JaxIndex(data, "train", download=False), path, 8,
                                           **kw))
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_after_kill(data, tmp_path, monkeypatch):
    """A killed pack resumes from the last flushed chunk, not from zero, and
    ends with the bytes of an uninterrupted pack."""
    index = ChexpertIndex(data, "valid", download=False)
    real, calls = packed.load_grayscale, {"n": 0}

    def dies_mid_pack(path, **kw):
        calls["n"] += 1
        if calls["n"] > 6:  # in the second chunk of 4
            raise RuntimeError("simulated kill")
        return real(path, **kw)

    monkeypatch.setattr(packed, "load_grayscale", dies_mid_pack)
    with pytest.raises(RuntimeError, match="simulated kill"):
        packed.build_packed_cache(index, str(tmp_path / "c"), image_size=SIZE, workers=1,
                                  chunk_rows=4)
    assert not glob.glob(str(tmp_path / "c" / "*.u8"))  # only .tmp and .progress
    calls["n"] = -100
    path = packed.build_packed_cache(index, str(tmp_path / "c"), image_size=SIZE, workers=1,
                                     chunk_rows=4)
    assert calls["n"] == -100 + 6  # rows 0-3 were kept: 6 of 10 decoded again
    monkeypatch.setattr(packed, "load_grayscale", real)
    fresh = packed.build_packed_cache(index, str(tmp_path / "d"), image_size=SIZE)
    assert _files(path) == _files(fresh)


def test_stale_lock_is_broken(data, tmp_path):
    index = ChexpertIndex(data, "valid", download=False)
    cache = tmp_path / "cache"
    cache.mkdir()
    path = packed.pack_cache_path(str(cache), "valid", SIZE, None,
                                  packed._index_key(index.all_indices()))
    with open(path + ".lock", "w") as f:
        f.write("99999\n")
    old = os.path.getmtime(path + ".lock") - 3600
    os.utime(path + ".lock", (old, old))
    assert packed.build_packed_cache(index, str(cache), image_size=SIZE, poll_sec=0.05,
                                     stale_sec=5.0) == path
    assert os.path.exists(path) and not os.path.exists(path + ".lock")


def test_concurrent_pack_exactly_one_packs(data, tmp_path):
    """Two processes ask for the same unbuilt cache: the .lock lets one
    decode while the other polls, then reads the finished cache."""
    cache = str(tmp_path / "cache")
    worker = f"""
import json, sys
import chexpert_tpu_torch.data.packed as packed
from chexpert_tpu_torch.data import ChexpertIndex

calls = [0]
real = packed.load_grayscale
def counting(*a, **kw):
    calls[0] += 1
    return real(*a, **kw)
packed.load_grayscale = counting
index = ChexpertIndex({data!r}, "train", download=False)
path = packed.build_packed_cache(index, {cache!r}, image_size={SIZE}, workers=2, poll_sec=0.05)
with open(sys.argv[1], "w") as f:
    json.dump({{"path": path, "decodes": calls[0]}}, f)
"""
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", worker, o], env=env) for o in outs]
    for p in procs:
        assert p.wait(timeout=300) == 0
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    assert results[0]["path"] == results[1]["path"]
    assert sorted(r["decodes"] for r in results) == [0, 20]
    assert np.load(results[0]["path"], mmap_mode="r").shape == (20, SIZE + 32, SIZE + 32)
    assert not os.path.exists(results[0]["path"] + ".lock")


def test_crop_and_flip_on_jax_draws_equals_jax_device_augment():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (6, 12, 12, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_device_augment(jnp.asarray(img), key, 8))
    r_top, r_left, r_flip = jax.random.split(key, 3)  # JAX's own draws, as it makes them
    tops = np.array(jax.random.randint(r_top, (6,), 0, 5))
    lefts = np.array(jax.random.randint(r_left, (6,), 0, 5))
    flips = np.array(jax.random.bernoulli(r_flip, 0.5, (6,)))
    assert flips.any() and not flips.all()
    got = crop_and_flip(torch.from_numpy(img), torch.from_numpy(tops), torch.from_numpy(lefts),
                        torch.from_numpy(flips), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_augment_draws_from_the_generator():
    img = torch.arange(2 * 10 * 10, dtype=torch.uint8).reshape(2, 10, 10, 1)
    a = device_augment(img, torch.Generator().manual_seed(1), 6)
    b = device_augment(img, torch.Generator().manual_seed(1), 6)
    assert a.shape == (2, 6, 6, 1) and torch.equal(a, b)
    windows = {tuple(img[0, t:t + 6, l:l + 6].flatten().tolist()) for t in range(5)
               for l in range(5)}
    windows |= {tuple(img[0, t:t + 6, l:l + 6].flip(1).flatten().tolist()) for t in range(5)
                for l in range(5)}
    assert tuple(a[0].flatten().tolist()) in windows


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_prepare_image_equals_jax(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randint(0, 256, (2, 5, 4, 1)) if dtype == "uint8" else rng.randn(2, 5, 4, 1))
    x = x.astype(dtype)
    want = np.asarray(jax_prepare_image(jnp.asarray(x)))
    got = prepare_image(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _train(data, out, *flags, n_epochs=1):
    main(["--train", "--data_path", data, "--output_dir", out, "--model", "densenet-tiny",
          "--image_size", str(SIZE), "--batch_size", "4", "--n_epochs", str(n_epochs),
          "--lr", "1e-3", "--log_interval", "1", "--eval_interval", "0",
          "--compute_dtype", "float32", "--data_workers", "2", "--device", "cpu", *flags])
    with open(os.path.join(out, "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r.get("tag") == "train_loss"]


def test_cli_packed_cache_device_aug_and_profile(data, tmp_path, monkeypatch):
    """--packed_cache builds the caches under the dataset's packed/ and trains
    from them; with --data_aug --device_aug every step crops on the device
    from the stored tiles; --profile over the 5 steps of an epoch leaves a
    trace (steps 3 and 4) that holds the port's spans as ranges, and the
    spans stop with it."""
    import chexpert_tpu_torch.train.steps as steps

    crops, real = [], steps.device_augment

    def counting(img, generator, size):
        crops.append(tuple(img.shape))
        return real(img, generator, size)

    monkeypatch.setattr(steps, "device_augment", counting)
    losses = _train(data, str(tmp_path / "aug"), "--packed_cache", "--data_aug", "--device_aug")
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert crops == [(4, SIZE + 32, SIZE + 32, 1)] * 5
    caches = glob.glob(os.path.join(data, "CheXpert-v1.0-small", "packed", "*.u8"))
    assert len(caches) >= 2  # train tiles with the crop margin, and valid
    losses = _train(data, str(tmp_path / "prof"), "--packed_cache", "--profile")
    assert len(losses) == 5
    trace = tmp_path / "prof" / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    with open(trace) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    for name in ("step", "step.forward", "step.backward", "step.optimizer"):
        assert names.count(name) == 2, name
    # step 4's wait and the one that ends the epoch; step 3's came before the trace
    assert names.count("input.next") == 2
    assert tracing.drain() == []
