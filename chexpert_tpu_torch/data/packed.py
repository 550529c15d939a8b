"""Packed image cache: decode the JPEGs once, then stream uint8 memmaps
(port of chexpert_tpu/data/packed.py, in its file format).

  * pack once: decode (optional min-edge resize, then center crop) every
    image of an index to a fixed size and store it in one uint8 ``.npy``
    memmap (N, S, S) named ``.u8``, with a ``.json`` sidecar (n, size, the
    original row indices);
  * train from it: an epoch reads raw bytes with no decode; crops are numpy
    slices, and the /255 whitening runs on the device.

The file name is keyed by (mode, size, resize, a hash of the row indices),
so a changed --data_filter or --mini_data gets its own file, and a reused
cache is checked against the index's rows. The path, the key, the format
and the numpy draws of the shuffle and the crops are the JAX package's:
either package reads the other's cache, and the two give equal batches for
the same seed and epoch. Packing is resumable (``.progress``) and one
process packs at a time (``.lock``, with a heartbeat and a stale-lock
break).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from chexpert_tpu_torch.data.chexpert import ChexpertIndex
from chexpert_tpu_torch.data.transforms import center_crop, load_grayscale, resize_min_edge


def pack_cache_path(
    cache_dir: str, mode: str, size: int, resize: Optional[int],
    index_key: str = "",
) -> str:
    tag = f"{mode}_s{size}" + (f"_r{resize}" if resize else "")
    if index_key:
        tag += f"_i{index_key}"
    return os.path.join(cache_dir, f"packed_{tag}.u8")


def _index_key(indices: np.ndarray) -> str:
    """Short content key over the row subset (two different filters of the
    same length must never share a cache file)."""
    return hashlib.sha1(np.asarray(indices, np.int64).tobytes()).hexdigest()[:8]


def _cache_valid(path: str, n: int, stored: int, indices: np.ndarray) -> bool:
    meta_path = path + ".json"
    if not (os.path.exists(path) and os.path.exists(meta_path)):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (ValueError, OSError):
        return False
    return (meta.get("n") == n and meta.get("size") == stored
            and meta.get("indices") == indices.tolist())


def _acquire_pack_lock(lock_path: str, heartbeat_paths, stale_sec: float) -> bool:
    """One packer at a time (ranks on a shared filesystem, or several
    processes of one host: without it every process packs the same index
    into the same .tmp memmap, duplicated decode work at best and a
    corrupted cache at worst). O_EXCL creation is the mutex; a lock whose
    holder died (no heartbeat on the lock or the .progress sidecar for
    stale_sec) is broken and retried."""
    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, f"{os.getpid()}\n".encode())
        os.close(fd)
        return True
    except FileExistsError:
        mtimes = []
        for p in (lock_path, *heartbeat_paths):
            try:
                mtimes.append(os.path.getmtime(p))
            except OSError:
                pass
        if mtimes and time.time() - max(mtimes) > stale_sec:
            try:  # steal the stale lock; losers of THIS race loop and retry
                os.remove(lock_path)
            except OSError:
                pass
        return False


def build_packed_cache(
    index: ChexpertIndex,
    cache_dir: str,
    image_size: int = 320,
    resize: Optional[int] = None,
    workers: int = 8,
    pack_margin: int = 32,
    chunk_rows: int = 512,
    poll_sec: float = 0.2,
    stale_sec: float = 120.0,
) -> str:
    """Decode+crop the whole index into a uint8 memmap. Returns the path.

    Images are stored at image_size + pack_margin so random-crop augmentation
    still has jitter room (the final crop happens at batch time).

    Packing is resumable: rows are decoded in chunks of ``chunk_rows``; after
    each chunk the memmap is flushed and a .progress sidecar records the done
    count, so a killed pack resumes from the last complete chunk.

    When several processes (ranks on a shared filesystem, or several
    processes of one host) ask for the same unbuilt cache, exactly one
    takes the .lock and packs; the others poll until the finished cache
    validates, then use it.
    """
    os.makedirs(cache_dir, exist_ok=True)
    stored = image_size + (pack_margin if index.mode == "train" else 0)
    indices = index.all_indices()
    key = _index_key(indices)
    path = pack_cache_path(cache_dir, index.mode, stored, resize, key)
    meta_path = path + ".json"
    n = len(index)
    if _cache_valid(path, n, stored, indices):
        return path

    lock_path = path + ".lock"
    tmp_path, prog_path = path + ".tmp", path + ".progress"
    while not _acquire_pack_lock(lock_path, (prog_path,), stale_sec):
        time.sleep(poll_sec)
        if _cache_valid(path, n, stored, indices):
            return path
    try:
        if _cache_valid(path, n, stored, indices):
            return path  # finished while we were waiting for the lock
        return _pack_locked(
            index, path, meta_path, tmp_path, prog_path, lock_path,
            n, stored, key, indices, resize, workers, chunk_rows,
        )
    finally:
        try:
            os.remove(lock_path)
        except OSError:
            pass


def _pack_locked(index, path, meta_path, tmp_path, prog_path, lock_path,
                 n, stored, key, indices, resize, workers, chunk_rows) -> str:
    # resume from a previous interrupted pack if its sidecar matches
    done = 0
    if os.path.exists(tmp_path) and os.path.exists(prog_path):
        try:
            with open(prog_path) as f:
                prog = json.load(f)
        except (ValueError, OSError):
            prog = {}
        if prog.get("n") == n and prog.get("size") == stored and prog.get("key") == key:
            done = min(int(prog.get("done_rows", 0)), n)
    if done:
        mm = np.lib.format.open_memmap(tmp_path, mode="r+")
        if mm.shape != (n, stored, stored) or mm.dtype != np.uint8:
            done = 0
    if not done:
        mm = np.lib.format.open_memmap(
            tmp_path, mode="w+", dtype=np.uint8, shape=(n, stored, stored)
        )

    def decode(pos: int) -> None:
        # match the JPEG pipeline semantics exactly: optional min-edge
        # resize, then center crop (reference chexpert.py:68-69)
        img = load_grayscale(index.path(pos), min_edge_hint=resize or 0)
        if resize:
            img = resize_min_edge(img, resize)
        arr = np.asarray(img, dtype=np.uint8)[..., None]
        mm[pos] = center_crop(arr, stored)[..., 0]

    with ThreadPoolExecutor(max(1, workers)) as pool:
        for start in range(done, n, chunk_rows):
            stop = min(start + chunk_rows, n)
            list(pool.map(decode, range(start, stop)))
            mm.flush()
            with open(prog_path + ".tmp", "w") as f:
                json.dump({"n": n, "size": stored, "key": key, "done_rows": stop}, f)
            os.replace(prog_path + ".tmp", prog_path)
    del mm
    os.replace(tmp_path, path)
    with open(meta_path, "w") as f:
        json.dump({"n": n, "size": stored, "indices": indices.tolist()}, f)
    if os.path.exists(prog_path):
        os.remove(prog_path)
    return path


class PackedBatches:
    """Epoch iterator over a packed cache, with the batch dict of
    ``data.pipeline.Batches`` (image, label, label_mask, index, mask); the
    image is uint8 (B, S, S, 1), whitened on the device
    (``train.steps.prepare_image``)."""

    def __init__(
        self,
        index: ChexpertIndex,
        cache_path: str,
        batch_size: int,
        image_size: int = 320,
        shuffle: bool = False,
        augment: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        epoch: int = 0,
        emit_stored: bool = False,
        host_slice: Optional[slice] = None,
    ):
        self.index = index
        self.mm = np.load(cache_path, mmap_mode="r")
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.augment = augment
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = epoch
        # emit the full stored tile (with its crop margin): the train step crops
        # and flips on the device (train/steps.py::device_augment)
        self.emit_stored = emit_stored
        # multi-process: this rank's contiguous rows of each global batch.
        # The shuffle order is seed-derived, the same on every rank; augment
        # draws are keyed by the global batch, so sliced and unsliced streams match.
        self.host_slice = host_slice or slice(0, batch_size)
        if len(self.mm) != len(index):
            raise ValueError(f"packed cache {cache_path} holds {len(self.mm)} rows, the index "
                             f"{len(index)}")

    def __len__(self) -> int:
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.index)
        order = np.arange(n)
        rng = np.random.RandomState(self.seed + 1_000_003 * self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        bs, s = self.batch_size, self.image_size
        lo, hi, _ = self.host_slice.indices(bs)
        local_bs = hi - lo  # this process's rows per global batch
        stored = self.mm.shape[1]
        labels = self.index.all_labels()
        indices = self.index.all_indices()
        for bi, start in enumerate(range(0, n, bs)):
            global_chunk = order[start : start + bs]
            if len(global_chunk) < bs and self.drop_last:
                break
            # padding lives at the global-batch tail, so the valid rows of a
            # contiguous host slice are a prefix of it
            batch_n = max(0, min(hi, len(global_chunk)) - lo)
            chunk = global_chunk[lo : lo + batch_n]
            raw = self.mm[np.sort(chunk)]  # sorted gather = sequential IO
            unsort = np.argsort(np.argsort(chunk))
            raw = raw[unsort]
            s_out = stored if self.emit_stored else s
            if self.emit_stored:
                img = raw  # device-side augment crops to image_size
            elif self.augment and stored > s:
                # draws keyed by (seed, epoch, global batch number) for the
                # whole global batch, then sliced: every rank sees the same
                # crop / flip for an example whatever its slice
                brng = np.random.RandomState(
                    (self.seed + 1_000_003 * self.epoch + 7_919 * bi) % (2**31)
                )
                tops = brng.randint(0, stored - s + 1, bs)[lo : lo + batch_n]
                lefts = brng.randint(0, stored - s + 1, bs)[lo : lo + batch_n]
                flips = (brng.rand(bs) < 0.5)[lo : lo + batch_n]
                # a zero-copy sliding-window view, then one fancy-index
                # gather for all the crops
                win = np.lib.stride_tricks.sliding_window_view(
                    raw, (s, s), axis=(1, 2)
                )
                img = win[np.arange(batch_n), tops, lefts]
                if flips.any():
                    img[flips] = img[flips, :, ::-1]
            else:
                off = (stored - s) // 2
                img = raw[:, off : off + s, off : off + s]

            # raw uint8 single-channel: 12x less host-to-device traffic than
            # f32 3-channel; the step whitens and expands on the device
            image = np.zeros((local_bs, s_out, s_out, 1), np.uint8)
            image[:batch_n, :, :, 0] = img
            label = np.zeros((local_bs, labels.shape[1]), np.float32)
            label[:batch_n] = labels[chunk]
            idx = np.zeros((local_bs,), np.int64)
            idx[:batch_n] = indices[chunk]
            mask = np.zeros((local_bs,), np.float32)
            mask[:batch_n] = 1.0
            label_mask = (label != -1.0).astype(np.float32)  # U-Ignore support
            label = np.clip(label, 0.0, 1.0)
            yield {"image": image, "label": label, "label_mask": label_mask,
                   "index": idx, "mask": mask}
