"""Frozen dataclass config with JSON round-trip: the port's own copy of
chexpert_tpu/configs/config.py (same field names, so one ``config.json``
serves both packages), plus ``device`` and ``ensemble_member_chunk``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

from chexpert_tpu_torch.parallel import multihost


@dataclass(frozen=True)
class Config:
    # --- actions (reference chexpert.py:31-36) ---
    train: bool = False
    evaluate_single_model: bool = False
    evaluate_ensemble: bool = False
    visualize: bool = False
    plot_roc: bool = False
    seed: int = 0

    # --- paths ---
    data_path: str = ""
    output_dir: str = ""
    restore: str = ""

    # --- model ---
    model: str = "densenet121"

    # --- data params ---
    mini_data: Optional[int] = None
    resize: Optional[int] = None
    # JSON row filter dict, e.g. '{"Frontal/Lateral": "Frontal"}'
    data_filter: str = ""

    # --- training params ---
    pretrained: bool = False
    batch_size: int = 16
    n_epochs: int = 1
    lr: float = 1e-4
    lr_warmup_steps: int = 0
    lr_decay_factor: float = 0.97
    log_interval: int = 50
    eval_interval: int = 300

    # 'ones' (U-Ones), 'zeros' (U-Zeros) or 'ignore' (U-Ignore)
    uncertain_policy: str = "ones"

    # compute dtype for conv/matmul activations (torch.autocast); params f32
    compute_dtype: str = "bfloat16"
    # 'pallas' (the hand-written attention kernels) or 'einsum' (plain math)
    attn_impl: str = "pallas"
    # host pipeline workers (thread pool for JPEG decode)
    data_workers: int = 8
    # batches moved to the device ahead of the step
    prefetch: int = 2
    image_size: int = 320
    # host-side random crop + flip
    data_aug: bool = False
    # resume from output_dir/checkpoint_latest.pt when present
    auto_resume: bool = False
    max_best_checkpoints: int = 10

    # --- the port's own: torch device of the run ('cuda' unless asked) ---
    device: str = "cuda"

    # members per ensemble pass; 0 = planned from the free device memory,
    # halved on an out-of-memory error
    ensemble_member_chunk: int = 0

    # --- multi-process training (chexpert_tpu_torch.parallel) ---
    data_parallel: int = 0
    model_parallel: int = 1
    multihost: bool = False

    # torch.profiler trace of train steps 3-12 of epoch 0 into output_dir/profile
    profile: bool = False
    # decode-once uint8 cache (data/packed.py) for the input pipeline
    packed_cache: bool = False
    # with packed_cache and data_aug: crop and flip in the train step on the device
    device_aug: bool = False

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def resolve_output_dir(cfg: Config, now: Optional[str] = None) -> Config:
    """Default output dir = results/<UTC timestamp> (reference chexpert.py:440-442)."""
    if cfg.output_dir:
        return cfg
    if cfg.restore:
        raise RuntimeError("Must specify `output_dir` argument")
    import time

    stamp = now or time.strftime("%Y-%m-%d_%H-%M-%S", time.gmtime())
    return cfg.replace(output_dir=os.path.join("results", stamp))


def setup_output_dir(cfg: Config) -> None:
    """Create output_dir and vis/ plots/ best_checkpoints/ subdirs and persist
    config.json once (reference chexpert.py:444-450). In a multi-process run
    every rank makes the directories, the primary writes config.json, and
    every rank waits for the others before it goes on."""
    os.makedirs(cfg.output_dir, exist_ok=True)
    for sub in ("vis", "plots", "best_checkpoints"):
        os.makedirs(os.path.join(cfg.output_dir, sub), exist_ok=True)
    cfg_path = os.path.join(cfg.output_dir, "config.json")
    if not os.path.exists(cfg_path) and multihost.is_primary():
        cfg.save(cfg_path)
    multihost.barrier()
