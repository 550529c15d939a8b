"""Host-side image transforms (numpy / PIL), torchvision semantics.

PIL is imported inside the functions that use it, so the module imports on
hosts without it.
"""

from __future__ import annotations

import numpy as np


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
