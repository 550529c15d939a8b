"""Dataset tooling CLI of the PyTorch port (counterpart of
chexpert_tpu/cli/data_tools.py): inspection, statistics and an EDA report.

Covers the reference's dataset smoke-test main (reference dataset.py:177-204:
dump decoded valid images with their labels, the streaming mean / std) and
the role of its explore_data.ipynb notebook (label NA handling, prevalence,
co-occurrence, conditions per image) as a CLI. Host only: no device.

    python -m chexpert_tpu_torch.cli.data_tools inspect  <data_dir> [--n 10]
    python -m chexpert_tpu_torch.cli.data_tools stats    <data_dir> [--limit N]
    python -m chexpert_tpu_torch.cli.data_tools explore  <data_dir> [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from chexpert_tpu_torch.data import (
    ATTR_NAMES,
    DIR_NAME,
    ChexpertIndex,
    compute_mean_and_std,
    decode_transform,
    denormalize,
)
from chexpert_tpu_torch.data.chexpert import _to_float, read_csv


def cmd_inspect(args) -> int:
    """Dump n decoded+normalized valid images as PNGs with printed labels
    (reference dataset.py:189-198)."""
    from PIL import Image

    index = ChexpertIndex(args.data_dir, "valid", download=False)
    print(f"Valid dataset loaded. Length: {len(index)}")
    out = args.out or "results/dataset_inspect"
    os.makedirs(out, exist_ok=True)
    for i in range(min(args.n, len(index))):
        arr = decode_transform(index.path(i), image_size=args.image_size)
        img = np.clip(denormalize(arr) * 255, 0, 255).astype(np.uint8)[..., 0]
        path = os.path.join(out, f"test_valid_dataset_image_{i}.png")
        Image.fromarray(img, mode="L").save(path)
        print(f"Patient id: {index.index(i)}; labels: {index.labels(i)}")
    print(f"Wrote {min(args.n, len(index))} images to {out}")
    return 0


def cmd_stats(args) -> int:
    """Streaming Welford mean/std over per-image means (dataset.py:163-174,
    published constants 0.5330 / 0.0349)."""
    index = ChexpertIndex(args.data_dir, "train", download=False,
                          mini_data=args.limit)

    def images():
        for i in range(len(index)):
            arr = decode_transform(index.path(i), image_size=args.image_size)
            yield denormalize(arr)  # back to [0, 1] like the reference's ToTensor

    m, s = compute_mean_and_std(images())
    print(f"Dataset mean: {m}; dataset std {s}")
    return 0


def cmd_explore(args) -> int:
    """EDA report: raw label distribution (NaN/-1/0/1), prevalence under
    U-Ones, co-occurrence matrix, conditions per image."""
    header, rows = read_csv(os.path.join(args.data_dir, DIR_NAME, "train.csv"))
    cols = [header.index(a) for a in ATTR_NAMES]
    raw = np.array([[_to_float(r[c]) for c in cols] for r in rows],
                   np.float64).reshape(len(rows), len(ATTR_NAMES))
    out = args.out or "results/explore"
    os.makedirs(out, exist_ok=True)

    lines = ["# CheXpert-small training-data exploration", ""]
    lines += [f"Rows: {len(raw)}", ""]

    # raw label value distribution per competition attribute
    lines += ["## Raw label values (blank=unmentioned, 0=neg, -1=uncertain, 1=pos)", ""]
    lines += ["| attribute | NaN | 0.0 | -1.0 | 1.0 |", "|---|---|---|---|---|"]
    for j, a in enumerate(ATTR_NAMES):
        c = raw[:, j]
        lines += [f"| {a} | {int(np.isnan(c).sum())} | {int((c == 0.0).sum())} "
                  f"| {int((c == -1.0).sum())} | {int((c == 1.0).sum())} |"]
    lines += [""]

    # U-Ones prevalence
    ones = np.where(np.isnan(raw), 0.0, raw)
    ones[ones == -1.0] = 1.0
    lines += ["## Prevalence under U-Ones", ""]
    lines += ["| attribute | positive fraction |", "|---|---|"]
    for j, a in enumerate(ATTR_NAMES):
        lines += [f"| {a} | {ones[:, j].mean():.4f} |"]
    lines += [""]

    # co-occurrence, written as pandas writes a labelled frame
    co = ones.T @ ones
    with open(os.path.join(out, "cooccurrence.csv"), "w") as f:
        f.write("," + ",".join(ATTR_NAMES) + "\n")
        for a, row in zip(ATTR_NAMES, co):
            f.write(a + "," + ",".join(repr(float(v)) for v in row) + "\n")
    lines += ["## Co-occurrence counts (U-Ones)", "",
              "See cooccurrence.csv", ""]

    # condition-count histogram
    counts, n = np.unique(ones.sum(1), return_counts=True)
    lines += ["## Conditions per image", ""]
    lines += ["| #conditions | images |", "|---|---|"]
    for k, v in zip(counts, n):
        lines += [f"| {int(k)} | {int(v)} |"]

    with open(os.path.join(out, "explore.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"Wrote report to {os.path.join(out, 'explore.md')}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("inspect", "stats", "explore"):
        sp = sub.add_parser(name)
        sp.add_argument("data_dir")
        sp.add_argument("--out", default="")
        sp.add_argument("--image_size", type=int, default=320)
        if name == "inspect":
            sp.add_argument("--n", type=int, default=10)
        if name == "stats":
            sp.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    return {"inspect": cmd_inspect, "stats": cmd_stats, "explore": cmd_explore}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
