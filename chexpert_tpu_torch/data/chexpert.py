"""CheXpert-small dataset index and label preprocessing, read and written
with the standard ``csv`` module (port of chexpert_tpu/data/chexpert.py,
whose pandas the card host does not have).

  * modes: train / valid / vis, and test (predict's input: ``root`` is a
    csv whose Path column is joined to '.', every label 0; a csv with only
    a Path column, as the competition's test csv, is taken);
  * labels: the 5 competition pathologies; NaN (unmentioned) -> 0 in train;
    uncertain -1 mapped by policy: 'ones' (U-Ones), 'zeros' (U-Zeros) or
    'ignore' (kept as -1; the pipeline masks it out of the loss);
  * optional row filter dict persisted as
    processed_training_data_filters.json;
  * processed CSV caches under the JAX package's file names
    (train.processed[.<policy>][.f<hash>].csv, valid.processed.csv), in the
    format pandas writes, so either package reads the other's cache;
  * vis mode: 3 examples per category (each single condition, no findings,
    exactly 2, more than 2);
  * mini_data head-N truncation; study ids from the Path column;
  * download and extract from the Stanford URL when the dataset directory
    is absent (``download=True``, the default, as in the JAX index);
  * ``compute_mean_and_std``: the dataset statistics by Welford's method.
"""

from __future__ import annotations

import csv
import hashlib
import json
import math
import os
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

URL = "http://download.cs.stanford.edu/deep/CheXpert-v1.0-small.zip"
DIR_NAME = os.path.splitext(os.path.basename(URL))[0]  # CheXpert-v1.0-small

ATTR_ALL_NAMES = [
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
    "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture",
    "Support Devices",
]
# competition labels, in the model's output order
ATTR_NAMES = ["Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Pleural Effusion"]

# dataset pixel statistics used to whiten [0, 1] images
PIXEL_MEAN = 0.5330
PIXEL_STD = 0.0349

MODES = ("train", "valid", "vis", "test")

# the cell strings pandas.read_csv reads as NaN by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _maybe_download_and_extract(root: str) -> None:
    """Download and unzip the dataset into ``root`` unless ``root/DIR_NAME``
    exists; a zip already beside it is extracted without a download
    (reference dataset.py:94-113)."""
    target = os.path.join(root, DIR_NAME)
    if os.path.exists(target):
        return
    fpath = os.path.join(root, os.path.basename(URL))
    if not os.path.exists(fpath):
        from urllib import request

        print(f"Downloading {URL} to {fpath}")

        def _progress(n_blocks, block_size, total_bytes):
            done = min(n_blocks * block_size, total_bytes)
            pct = 100.0 * done / max(total_bytes, 1)
            print(f"\rdownload: {pct:5.1f}% of {total_bytes} bytes", end="", flush=True)

        request.urlretrieve(URL, fpath, _progress)
        print()
    print(f"Extracting {fpath}")
    with zipfile.ZipFile(fpath, "r") as z:
        z.extractall(root)
    macosx = os.path.join(target, "__MACOSX")
    if os.path.exists(macosx):
        os.rmdir(macosx)
    os.unlink(fpath)
    print("Dataset extracted.")


def read_csv(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows of cell strings), NA cells normalized to ''."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [["" if c in NA_STRINGS else c for c in row] for row in reader]
    return header, rows


def write_csv(path: str, header: Sequence[str], rows: Sequence[Sequence[str]]) -> None:
    """Written beside ``path`` and renamed over it, so a concurrent reader
    (another rank building the same processed cache) sees the whole file or
    none of it."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)
    os.replace(tmp, path)


def format_float(x: float) -> str:
    """A float cell as pandas writes it: repr, and '' for NaN."""
    return "" if np.isnan(x) else repr(float(x))


def _to_float(cell: str) -> float:
    return float("nan") if cell == "" else float(cell)


def _matches(cell: str, want) -> bool:
    """Row-filter equality: strings compare as strings, numbers as numbers."""
    if isinstance(want, str):
        return cell == want
    try:
        return _to_float(cell) == want
    except ValueError:
        return False


def _preprocess_train(header, rows, data_filter: Optional[Dict], uncertain_policy: str,
                      csv_dir: str):
    """NaN -> 0, -1 -> policy, optional row filter (reference dataset.py:134-153)."""
    if uncertain_policy not in ("ones", "zeros", "ignore"):
        raise ValueError(f"unknown uncertain_policy: {uncertain_policy}")
    uncertain_to = {"ones": 1.0, "zeros": 0.0, "ignore": -1.0}[uncertain_policy]
    cols = [header.index(a) for a in ATTR_NAMES]
    out = []
    for row in rows:
        row = list(row)
        for c in cols:
            x = _to_float(row[c])
            x = 0.0 if np.isnan(x) else (uncertain_to if x == -1.0 else x)
            row[c] = format_float(x)
        out.append(row)
    if data_filter is not None:
        for key, want in data_filter.items():
            c = header.index(key)
            out = [row for row in out if _matches(row[c], want)]
        with open(os.path.join(csv_dir, "processed_training_data_filters.json"), "w") as f:
            json.dump(data_filter, f)
    return out


class ChexpertIndex:
    """Index over CheXpert-small; a row is (image path, labels, original index).

    ``root`` is the data directory holding CheXpert-v1.0-small/; in test mode
    it is a csv path, and its Path column is joined to '.' (reference
    dataset.py:37). As in the JAX index, test mode takes no filter and no
    ``mini_data``, and the other modes download the dataset into ``root``
    when it is absent unless ``download=False``."""

    def __init__(
        self,
        root: str,
        mode: str = "train",
        data_filter: Optional[Dict[str, str]] = None,
        mini_data: Optional[int] = None,
        uncertain_policy: str = "ones",
        download: bool = True,
    ):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.root = os.path.expanduser(root)
        self.mode = mode
        if mode == "test":
            header, rows = read_csv(self.root)
            self.root = "."
            # the label columns a test csv lacks are appended, and every label is 0
            self.columns = header + [a for a in ATTR_NAMES if a not in header]
            self._set_rows(rows, np.zeros((len(rows), len(ATTR_NAMES)), np.float32))
            return
        if download:
            _maybe_download_and_extract(self.root)
        csv_dir = os.path.join(self.root, DIR_NAME)
        self.columns, rows = self._load_processed(csv_dir, data_filter, uncertain_policy)
        attr_idxs = [self.columns.index(a) for a in ATTR_NAMES]
        self._set_rows(rows, np.array([[_to_float(row[c]) for c in attr_idxs] for row in rows],
                                      np.float32).reshape(len(rows), len(ATTR_NAMES)))
        if mini_data is not None:
            self._take(slice(None, mini_data))
        if mode == "vis":
            self._select_vis_subset()

    def _set_rows(self, rows, labels: np.ndarray) -> None:
        path_col = self.columns.index("Path")
        self.attr_idxs = [self.columns.index(a) for a in ATTR_NAMES]
        self._paths = [row[path_col] for row in rows]
        self._labels = labels
        self._index = np.arange(len(rows), dtype=np.int64)
        self._by_index = dict(zip(self._index.tolist(), self._paths))

    def _load_processed(self, csv_dir: str, data_filter, uncertain_policy: str):
        suffix = "" if uncertain_policy == "ones" else f".{uncertain_policy}"
        if data_filter:
            # cache keyed by filter so a filtered run never reuses an unfiltered one
            h = hashlib.sha1(json.dumps(data_filter, sort_keys=True).encode()).hexdigest()[:8]
            suffix += f".f{h}"
        train_cache = os.path.join(csv_dir, f"train.processed{suffix}.csv")
        valid_cache = os.path.join(csv_dir, "valid.processed.csv")
        if not (os.path.exists(train_cache) and os.path.exists(valid_cache)):
            valid_header, valid_rows = read_csv(os.path.join(csv_dir, "valid.csv"))
            header, rows = read_csv(os.path.join(csv_dir, "train.csv"))
            rows = _preprocess_train(header, rows, data_filter, uncertain_policy, csv_dir)
            write_csv(train_cache, header, rows)
            write_csv(valid_cache, valid_header, valid_rows)
        return read_csv(valid_cache if self.mode in ("valid", "vis") else train_cache)

    def _take(self, sel) -> None:
        self._paths = list(np.array(self._paths, dtype=object)[sel])
        self._labels = self._labels[sel]
        self._index = self._index[sel]

    def _select_vis_subset(self) -> None:
        """(reference dataset.py:50-68)"""
        labels = self._labels
        cond_sum = np.nansum(labels, axis=1)
        masks = [(labels[:, k] == 1) & (cond_sum == 1) for k in range(len(ATTR_NAMES))]
        masks += [cond_sum == 0, cond_sum == 2, cond_sum > 2]
        self.vis_attrs = ATTR_NAMES + ["No findings", "2 conditions", "Multiple conditions"]
        self.vis_idxs = [self._index[m][:3].tolist() for m in masks]
        pos = {int(i): p for p, i in enumerate(self._index)}
        self._take(np.array([pos[i] for sub in self.vis_idxs for i in sub], dtype=np.int64))

    def __len__(self) -> int:
        return len(self._paths)

    def path(self, pos: int) -> str:
        """Filesystem path of the pos-th image."""
        return os.path.join(self.root, self._paths[pos])

    def labels(self, pos: int) -> np.ndarray:
        return self._labels[pos].copy()

    def index(self, pos: int) -> int:
        """Original row index in the processed csv (reference dataset.py:86-88)."""
        return int(self._index[pos])

    def all_labels(self) -> np.ndarray:
        return self._labels.copy()

    def all_indices(self) -> np.ndarray:
        return self._index.copy()


def extract_patient_ids(index: ChexpertIndex, idxs: Sequence[int]) -> np.ndarray:
    """Original row indices -> study ids like
    'CheXpert-v1.0-small/valid/patient64541/study1' (reference dataset.py:156-160)."""
    return np.array([index._by_index[int(i)].rsplit("/", 1)[0] for i in idxs], dtype=object)


def compute_mean_and_std(image_iter) -> Tuple[float, float]:
    """Welford's streaming mean and standard deviation over per-image means
    (reference dataset.py:163-174); ``image_iter`` yields float arrays in
    [0, 1]."""
    m, s, k = 0.0, 0.0, 1
    for img in image_iter:
        x = float(np.mean(img))
        new_m = m + (x - m) / k
        s += (x - m) * (x - new_m)
        m = new_m
        k += 1
    return m, math.sqrt(s / (k - 1))
