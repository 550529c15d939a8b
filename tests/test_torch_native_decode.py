"""The port's native libjpeg decoder (chexpert_tpu_torch/native), built with
g++ at first use into the package's build directory, against the JAX
package's: the same bytes unscaled and under DCT-domain downscaling, and the
transforms' native / PIL switch. Exact: both are the same libjpeg."""

import numpy as np
import pytest
from PIL import Image

from chexpert_tpu import native as jax_native
from chexpert_tpu.data.transforms import load_grayscale as jax_load_grayscale
from chexpert_tpu_torch import native
from chexpert_tpu_torch.data import transforms


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for name, shape in (("small.jpg", (390, 320)), ("big.jpg", (1400, 1200))):
        smooth = np.cumsum(rng.randn(*shape), axis=1)
        img = np.clip(128 + 40 * smooth / np.abs(smooth).max() + 20 * rng.randn(*shape), 0, 255)
        Image.fromarray(img.astype(np.uint8), "L").save(str(d / name), quality=90)
        paths.append(str(d / name))
    return paths


def test_the_library_builds_into_the_build_directory():
    assert native.available(), "g++ and jpeglib.h are on this host: the build must succeed"
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"


@pytest.mark.parametrize("hint", [0, 300, 600, 601, 175])
def test_decode_equals_jax(jpegs, hint):
    if not jax_native.available():
        pytest.skip("the JAX package's native decoder does not build here")
    for path in jpegs:
        got, want = native.decode_gray(path, hint), jax_native.decode_gray(path, hint)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    big = native.decode_gray(jpegs[1], hint)
    assert min(big.shape) >= hint  # never below the hint
    if hint == 600:
        assert big.shape == (700, 600)  # 1200 / 2: the DCT-domain downscale


def test_unscaled_decode_equals_pil(jpegs):
    for path in jpegs:
        np.testing.assert_array_equal(native.decode_gray(path),
                                      np.asarray(Image.open(path).convert("L")))


def test_load_grayscale_native_and_env_switch(jpegs, monkeypatch):
    path = jpegs[1]
    scaled = np.asarray(transforms.load_grayscale(path, min_edge_hint=300))
    np.testing.assert_array_equal(scaled, np.asarray(jax_load_grayscale(path, min_edge_hint=300)))
    assert scaled.shape == (350, 300)  # native: decoded at 1/4
    monkeypatch.setenv("CHEXPERT_TPU_NO_NATIVE", "1")

    def refused(*a, **kw):
        raise AssertionError("CHEXPERT_TPU_NO_NATIVE is set: PIL decodes")

    monkeypatch.setattr(native, "decode_gray", refused)
    pil = np.asarray(transforms.load_grayscale(path, min_edge_hint=300))
    assert pil.shape == (1400, 1200)
    np.testing.assert_array_equal(pil, np.asarray(Image.open(path).convert("L")))


def test_a_refused_file_falls_back_to_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(np.full((8, 8), 7, np.uint8), "L").save(path)

    def refuses(*a, **kw):
        raise ValueError("native JPEG decode failed (rc=1)")

    monkeypatch.setattr(native, "decode_gray", refuses)
    assert np.asarray(transforms.load_grayscale(path)).tolist() == [[7] * 8] * 8


def test_no_compiler_means_no_native(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "COMPILERS", ("no-such-compiler",))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "decode-x.so")
    assert native.decode_gray("unused.jpg") is None and not native.available()
