"""Inputs made from the run's seed: radiograph-like grayscale JPEGs, the
CheXpert-small tree that the program's input path reads, CIFAR-shaped
images, and the arrival schedule of an open loop.

Every seed gets the same sizes, file shapes and arrivals, and other pixel
values in another order, so that seeds change the data and not the amount
of work."""

from __future__ import annotations

import io
import os

import numpy as np

# CheXpert-small's csv header (the five competition labels among the 14)
META = ["Path", "Sex", "Age", "Frontal/Lateral", "AP/PA"]
LABELS_14 = ["No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
             "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
             "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture",
             "Support Devices"]
DIR = "CheXpert-v1.0-small"


def seed32(seed: int) -> int:
    """The seed as numpy's RandomState takes it (32 bits)."""
    return seed % (2 ** 32)


def shapes(n: int, short: int):
    """n (height, width) pairs: the short side ``short``, the other up to a
    fifth longer, in a fixed cycle (CheXpert-small's frontal and lateral
    views)."""
    extra = (0, 36, 70, 16, 52)
    out = []
    for i in range(n):
        long = short + extra[i % len(extra)] * short // 320
        out.append((long, short) if i % 2 else (short, long))
    return out


def _smooth_noise(rng: np.random.RandomState, h: int, w: int, scale: int) -> np.ndarray:
    """Unit-variance noise correlated over about ``scale`` pixels (white
    noise on a coarse grid, upsampled bilinearly)."""
    gh, gw = h // scale + 2, w // scale + 2
    g = rng.standard_normal((gh, gw)).astype(np.float32)
    y = np.linspace(0, gh - 1.001, h)
    x = np.linspace(0, gw - 1.001, w)
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    out = top * (1 - fy) + bot * fy
    return out / out.std()


def radiograph(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A grayscale image about CheXpert's mean (0.533 of full scale): a few
    broad blobs, a vertical gradient and rib-like bands, texture at scales
    of 32, 8 and 2 pixels, and quantum noise; uint8 (h, w)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 136.0 + 12.0 * (y / h - 0.5)
    for _ in range(5):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.15, 0.85) * w
        sy, sx = rng.uniform(0.08, 0.3) * h, rng.uniform(0.08, 0.3) * w
        img += rng.uniform(-20, 20) * np.exp(-((y - cy) / sy) ** 2 - ((x - cx) / sx) ** 2)
    img += 3.0 * np.sin(y / h * rng.uniform(20, 40) + rng.uniform(0, 6.3))
    for scale, amp in ((32, 8.0), (8, 5.0), (2, 3.0)):
        img += amp * _smooth_noise(rng, h, w, scale)
    img += rng.normal(0.0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_pool(seed: int, n: int, short: int, quality: int = 90):
    """n JPEG byte strings of radiographs; the shapes fixed, their order and
    pixels drawn from the seed."""
    from PIL import Image

    rng = np.random.RandomState(seed32(seed))
    sizes = [shapes(n, short)[i] for i in rng.permutation(n)]
    out = []
    for h, w in sizes:
        buf = io.BytesIO()
        Image.fromarray(radiograph(rng, h, w), "L").save(buf, format="JPEG", quality=quality)
        out.append(buf.getvalue())
    return out


def chexpert_tree(root: str, seed: int, n_rows: int, pool: int, short: int):
    """Write ``root/CheXpert-v1.0-small/{train,valid}.csv`` and a pool of
    ``pool`` JPEGs that the train csv's ``n_rows`` rows use in turn. Labels of
    the 14 columns: 1, 0, -1 (uncertain) or blank, drawn from the seed.
    Returns (relative paths of the rows, raw label strings of the rows)."""
    import csv

    rng = np.random.RandomState(seed32(seed) ^ 0x5EED)
    files = []
    for i, data in enumerate(jpeg_pool(seed, pool, short)):
        rel = f"{DIR}/train/patient{i + 1:05d}/study1/view1_frontal.jpg"
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)
        files.append(rel)
    cells = np.array(["1.0", "0.0", "-1.0", ""])
    draws = rng.choice(4, size=(n_rows, len(LABELS_14)), p=[0.3, 0.3, 0.1, 0.3])
    paths = [files[i % pool] for i in range(n_rows)]
    labels = cells[draws]
    header = META + LABELS_14
    with open(os.path.join(root, DIR, "train.csv"), "w", newline="") as f:
        wr = csv.writer(f, lineterminator="\n")
        wr.writerow(header)
        for p, lab in zip(paths, labels):
            wr.writerow([p, "Female", "60", "Frontal", "AP", *lab])
    with open(os.path.join(root, DIR, "valid.csv"), "w", newline="") as f:
        wr = csv.writer(f, lineterminator="\n")
        wr.writerow(header)
        wr.writerow([paths[0], "Female", "60", "Frontal", "AP", *(["0.0"] * len(LABELS_14))])
    return paths, labels


def cifar(seed: int, n: int, n_classes: int):
    """n CIFAR-shaped images (n, 32, 32, 3) uint8 and labels in [0, classes)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, n_classes, n).astype(np.int64))


def poisson_dues(rate: float, seconds: float):
    """Due times (s from the window's start) of an open loop at ``rate``:
    round(rate * seconds) exponential gaps, scaled to fill the window, drawn
    once from a fixed seed. Every run replays the same arrivals; the seed
    draws the images and which request sends which."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.RandomState(20251017).exponential(1.0, n)
    gaps = gaps * (seconds / gaps.sum())
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]).tolist()
