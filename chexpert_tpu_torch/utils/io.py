"""JSON IO helpers (reference chexpert.py:81-88) and the entry points'
device resolution. In a multi-process run only the primary process (rank
0) writes: every rank computes the same metrics (eval gathers), and the
others would only race on the same files."""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from chexpert_tpu_torch.parallel.multihost import is_primary


def save_json(data: Any, filename: str, output_dir: str) -> str:
    path = os.path.join(output_dir, filename + ".json")
    if not is_primary():
        return path
    with open(path, "w") as f:
        json.dump(data, f, indent=4)
    return path


def load_json(file_path: str) -> Any:
    with open(file_path) as f:
        return json.load(f)


def resolve_device(name: str) -> torch.device:
    """The torch device an entry point runs on; asking for ``cuda`` on a host
    without a card raises instead of running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} asked for, but no CUDA device is available")
    return device
