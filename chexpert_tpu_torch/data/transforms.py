"""Host-side image transforms (numpy / PIL), torchvision semantics; port of
chexpert_tpu/data/transforms.py.

Reference order: optional Resize(min-edge), CenterCrop(image_size or
resize), /255, whiten with the dataset statistics, expand 1 -> 3 channels;
plus the data-augmentation stack (random crop + horizontal flip). Images stay
single-channel (NHWC) until the channel expand, which the training path does
on the device (``train/steps.py::prepare_image``).

Decoding is PIL's (libjpeg); the JAX package's native libjpeg decoder with
DCT-domain downscaling is ROADMAP.md slice 8. PIL is imported inside the
functions that use it, so the module imports on hosts without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD


def load_grayscale(path: str):
    """Decode to an 8-bit grayscale PIL image."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return img


def resize_min_edge(img, size: int):
    """torchvision T.Resize semantics: min edge -> size, keep aspect."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        return img.resize((size, max(1, round(h * size / w))), Image.BILINEAR)
    return img.resize((max(1, round(w * size / h)), size), Image.BILINEAR)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision T.CenterCrop semantics incl. zero-pad when smaller."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        ph, pw = max(0, size - h), max(0, size - w)
        arr = np.pad(
            arr,
            ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)) + ((0, 0),) * (arr.ndim - 2),
        )
        h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top : top + size, left : left + size]


def random_crop(arr: np.ndarray, size: int, rng: np.random.RandomState) -> np.ndarray:
    h, w = arr.shape[:2]
    if h < size or w < size:
        return center_crop(arr, size)
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    return arr[top : top + size, left : left + size]


def decode_transform(
    path: str,
    image_size: int = 320,
    resize: Optional[int] = None,
    augment: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Decode one image to (H, W, 1) float32, whitened: resize -> crop ->
    /255 -> whiten. With augment=True the crop is random and a horizontal
    flip is drawn from ``rng``."""
    crop = resize if resize else image_size
    img = load_grayscale(path)
    if resize:
        img = resize_min_edge(img, resize)
    arr = np.asarray(img, dtype=np.float32)[..., None]
    if augment:
        if rng is None:
            raise ValueError("augment=True needs an rng")
        arr = random_crop(arr, crop, rng)
        if rng.rand() < 0.5:
            arr = arr[:, ::-1]
    else:
        arr = center_crop(arr, crop)
    arr = arr / 255.0
    arr = (arr - PIXEL_MEAN) / PIXEL_STD
    return np.ascontiguousarray(arr)


def expand_channels(batch: np.ndarray) -> np.ndarray:
    """(B, H, W, 1) -> (B, H, W, 3) (reference chexpert.py:72)."""
    return np.broadcast_to(batch, batch.shape[:-1] + (3,)).copy()


def denormalize(img: np.ndarray) -> np.ndarray:
    """Invert whitening for visualization (reference chexpert.py:320)."""
    return img * PIXEL_STD + PIXEL_MEAN
