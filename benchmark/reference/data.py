"""The reference's own input path: what the program's input layer should
make of the generated files, worked out again with PIL and numpy."""

from __future__ import annotations

import io

import numpy as np
import torch

LABELS_5 = ["Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Pleural Effusion"]


def shuffled_rows(n: int, seed: int, epoch: int = 0) -> np.ndarray:
    """The epoch's row order: numpy's RandomState(seed + epoch) shuffle."""
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def center_crop(a: np.ndarray, size: int) -> np.ndarray:
    h, w = a.shape
    top, left = (h - size) // 2, (w - size) // 2
    return a[top:top + size, left:left + size]


def radiograph_input(jpeg: bytes, size: int, mean: float, std: float) -> np.ndarray:
    """(3, size, size) float64: decode to 8-bit gray, center crop, scale to
    [0, 1], whiten with the dataset's statistics, repeat to 3 channels."""
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg))
    a = np.asarray(img.convert("L") if img.mode != "L" else img, dtype=np.float64)
    a = (center_crop(a, size) / 255.0 - mean) / std
    return np.repeat(a[None], 3, axis=0)


def chexpert_targets(label_cells, column_names) -> np.ndarray:
    """(rows, 5) targets of the five competition labels from the raw csv
    cells: uncertain (-1) counts as positive (U-Ones), blank as negative."""
    cols = [list(column_names).index(n) for n in LABELS_5]
    out = np.zeros((len(label_cells), 5))
    for r, cells in enumerate(label_cells):
        for j, c in enumerate(cols):
            v = float(cells[c]) if cells[c] != "" else 0.0
            out[r, j] = 1.0 if v == -1.0 else v
    return out


def cifar_augmented(x_uint8: np.ndarray, rng: np.random.RandomState, mean, std) -> np.ndarray:
    """(n, 3, 32, 32) float64: reflect-pad 4, crop 32 at offsets drawn from
    ``rng`` (rows, then columns, each in [0, 8]), mirrored where a uniform
    draw is under 1/2, normalized per channel."""
    n = len(x_uint8)
    tops, lefts = rng.randint(0, 9, n), rng.randint(0, 9, n)
    flips = rng.rand(n) < 0.5
    out = np.empty((n, 32, 32, 3))
    for i in range(n):
        src = x_uint8[i].astype(np.float64)
        rows = np.abs(np.arange(tops[i] - 4, tops[i] + 28))
        rows = np.where(rows > 31, 62 - rows, rows)
        cols = np.abs(np.arange(lefts[i] - 4, lefts[i] + 28))
        cols = np.where(cols > 31, 62 - cols, cols)
        img = src[rows][:, cols]
        out[i] = img[:, ::-1] if flips[i] else img
    out = (out / 255.0 - np.asarray(mean)) / np.asarray(std)
    return out.transpose(0, 3, 1, 2)


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=torch.float32)
