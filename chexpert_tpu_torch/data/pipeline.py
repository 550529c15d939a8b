"""Host input pipeline: threaded JPEG decode -> numpy batches -> device
prefetch (port of chexpert_tpu/data/pipeline.py).

  * a thread pool decodes and crops JPEGs (PIL releases the GIL in decode);
  * train batches drop the last partial batch (a zero-padded one would
    pollute the BatchNorm batch statistics); eval batches zero-pad the last
    one and carry a validity mask, so every batch has one shape;
  * augmentation draws from a RandomState seeded per example from (seed,
    epoch, position), so batches do not depend on the worker schedule, and
    neither they nor the shuffle order depend on the rank;
  * in a multi-process run each rank loads its ``host_slice`` of every
    global batch (``parallel.mesh.host_batch_slice_from_mesh``); the padding
    of the last global batch sits at its tail, so the valid rows of any
    slice are a prefix of it, and the ranks' slices in row order tile the
    one-process batches exactly;
  * ``device_prefetch`` copies batches from pinned host memory to the card
    on a side stream, ``depth`` batches ahead of the step.

Batch dict: image (B, H, W, 1) f32 whitened (the 1 -> 3 channel expand runs
on the device), label (B, 5) f32 in [0, 1], label_mask (B, 5) f32 (0 where
the label is uncertain under U-Ignore), index (B,) i64 original row indices,
mask (B,) f32 (0 for padding).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from chexpert_tpu_torch.data.chexpert import ChexpertIndex
from chexpert_tpu_torch.data.transforms import decode_transform


class Batches:
    """Iterable over one epoch of batches (host numpy)."""

    def __init__(
        self,
        index: ChexpertIndex,
        batch_size: int,
        shuffle: bool = False,
        augment: bool = False,
        image_size: int = 320,
        resize: Optional[int] = None,
        workers: int = 8,
        drop_last: bool = False,
        seed: int = 0,
        epoch: int = 0,
        host_slice: Optional[slice] = None,
    ):
        self.index = index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.image_size = image_size
        self.resize = resize
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = epoch
        self.host_slice = host_slice or slice(0, batch_size)

    def __len__(self) -> int:
        n = len(self.index)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _decode(self, pos: int, rng: Optional[np.random.RandomState]) -> np.ndarray:
        return decode_transform(self.index.path(pos), image_size=self.image_size,
                                resize=self.resize, augment=self.augment, rng=rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        hw = self.resize or self.image_size
        bs = self.batch_size
        lo, hi, _ = self.host_slice.indices(bs)
        local_bs = hi - lo  # this rank's rows of each global batch
        with ThreadPoolExecutor(self.workers) as pool:
            for start in range(0, n, bs):
                global_chunk = order[start : start + bs]
                if len(global_chunk) < bs and self.drop_last:
                    break
                nb = max(0, min(hi, len(global_chunk)) - lo)
                chunk = global_chunk[lo : lo + nb]
                rngs = [
                    np.random.RandomState(
                        (self.seed * 1_000_003 + self.epoch * 10_007 + int(p)) % (2**31))
                    if self.augment else None
                    for p in chunk
                ]
                imgs = list(pool.map(self._decode, chunk, rngs))
                image = np.zeros((local_bs, hw, hw, 1), np.float32)
                label = np.zeros((local_bs, len(self.index.attr_idxs)), np.float32)
                idx = np.zeros((local_bs,), np.int64)
                mask = np.zeros((local_bs,), np.float32)
                if nb:
                    image[:nb] = np.stack(imgs)
                    label[:nb] = np.stack([self.index.labels(p) for p in chunk])
                    idx[:nb] = [self.index.index(p) for p in chunk]
                    mask[:nb] = 1.0
                # U-Ignore: -1 labels excluded from the loss per element
                label_mask = (label != -1.0).astype(np.float32)
                yield {"image": image, "label": np.clip(label, 0.0, 1.0),
                       "label_mask": label_mask, "index": idx, "mask": mask}


def device_prefetch(batches, device, depth: int = 2):
    """Yield each batch as a dict of tensors on ``device``.

    A producer thread decodes ahead; on a CUDA device it also pins each batch
    and starts its copy on a side stream, so up to ``depth`` batches are in
    flight while the step runs; the consumer's stream waits for the copy's
    event before the batch is used. The producer exits promptly when the
    consumer abandons the generator (its put is bounded and re-checks a
    close event), and a producer error is raised in the consumer."""
    device = torch.device(device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(b):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
        if copy_stream is None:
            return {k: t.to(device) for k, t in host.items()}, None
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            dev = {k: t.pin_memory().to(device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return dev, done

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = object()
    closed = threading.Event()
    err: list = []

    def offer(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not offer(put(b)):
                    return
        except BaseException as e:  # surfaced in the consumer, which re-raises it
            err.append(e)
        finally:
            offer(stop)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            dev, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in dev.values():
                    t.record_stream(stream)
            yield dev
    finally:
        closed.set()
        thread.join(timeout=60)
