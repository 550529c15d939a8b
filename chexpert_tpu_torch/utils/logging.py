"""Scalar metric logging: an append-only JSONL log, ``scalars.jsonl``, one
object per line (the JAX package's MetricsWriter without its optional
TensorBoard mirror). In a multi-process run only the primary process (rank
0) writes; every rank computes the same scalars."""

from __future__ import annotations

import json
import os
import time

from chexpert_tpu_torch.parallel.multihost import is_primary


class MetricsWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        self._f = None
        if is_primary():
            os.makedirs(logdir, exist_ok=True)
            self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def _write(self, rec: dict) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()})

    def add_text(self, tag: str, text: str) -> None:
        self._write({"tag": tag, "text": text, "ts": time.time()})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
