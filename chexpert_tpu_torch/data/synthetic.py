"""Synthetic CheXpert-small fixture: port of chexpert_tpu/data/synthetic.py
with the same on-disk layout, labels, JPEG bytes and RNG draws, written with
the standard ``csv`` module (in the format pandas writes).

Each pathology k brightens horizontal band k of the image when positive, so
a model can fit the fixture. ``label_noise`` flips stored labels while the
image keeps the true label; ``weak_frac`` gives some true positives a faint
band, which in train are stored as uncertain (-1) with probability
``uncertain_frac`` (with weak_frac == 0, uncertain_frac applies to every
train positive). See the JAX module's docstring for why.
"""

from __future__ import annotations

import os

import numpy as np

from chexpert_tpu_torch.data.chexpert import (
    ATTR_ALL_NAMES,
    ATTR_NAMES,
    DIR_NAME,
    format_float,
    write_csv,
)

META_COLUMNS = ["Path", "Sex", "Age", "Frontal/Lateral", "AP/PA"]


def make_synthetic_dataset(
    root: str,
    n_train: int = 32,
    n_valid: int = 16,
    image_size: int = 64,
    seed: int = 0,
    views_per_study: int = 1,
    uncertain_frac: float = 0.0,
    label_noise: float = 0.0,
    weak_frac: float = 0.0,
    strong_amp: float = 150.0,
    weak_amp: float = 45.0,
) -> str:
    """Write a synthetic dataset under root/CheXpert-v1.0-small. Returns root."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = os.path.join(root, DIR_NAME)
    os.makedirs(base, exist_ok=True)
    header = META_COLUMNS + ATTR_ALL_NAMES
    label_col = {a: header.index(a) for a in ATTR_NAMES}

    def gen_split(split: str, n: int, start_patient: int) -> None:
        rows = []
        for i in range(n):
            patient = start_patient + i // views_per_study
            study = 1
            view = i % views_per_study + 1
            true = (rng.rand(len(ATTR_NAMES)) < 0.4).astype(np.float32)
            weak = rng.rand(len(ATTR_NAMES)) < weak_frac
            img = rng.randint(0, 60, size=(image_size, image_size)).astype(np.float32)
            band = image_size // len(ATTR_NAMES)
            for k, on in enumerate(true):
                if on:
                    amp = weak_amp if weak[k] else strong_amp
                    img[k * band : (k + 1) * band] += amp
            img = np.clip(img, 0, 255).astype(np.uint8)

            rel = f"{DIR_NAME}/{split}/patient{patient:05d}/study{study}/view{view}_frontal.jpg"
            fpath = os.path.join(root, rel)
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            Image.fromarray(img).save(fpath, quality=95)

            stored = true.copy()
            if label_noise > 0:
                flip = rng.rand(len(ATTR_NAMES)) < label_noise
                stored = np.where(flip, 1.0 - stored, stored)

            row = [rel, "Male", "60", "Frontal", "AP"] + [""] * len(ATTR_ALL_NAMES)
            for k, a in enumerate(ATTR_NAMES):
                v = float(stored[k])
                if split == "train" and v == 1.0 and true[k] == 1.0:
                    mark = weak[k] if weak_frac > 0 else True
                    if mark and rng.rand() < uncertain_frac:
                        v = -1.0  # uncertain label (U-Ones/U-Zeros channel)
                row[label_col[a]] = format_float(v)
            rows.append(row)
        # valid ships fully labeled: its competition labels are never NaN or -1
        write_csv(os.path.join(base, f"{split}.csv"), header, rows)

    gen_split("train", n_train, start_patient=1)
    gen_split("valid", n_valid, start_patient=10_000)
    return root
