"""Checkpoint storage of the port: ``.pt`` files holding
``{"global_step", "eval_loss", "avg_auc", "state_dict"}`` (the reference
training loop's format) and, beside them, ``optim_<name>.pt`` holding the
optimizer's and the LR scheduler's state dicts and, where the run has one,
the state of its train-mode generator. Every write is atomic
(tmp + rename) so a preempted host never leaves a torn file.

A plain state dict (a ``.pth`` written by the JAX package's
``models/pretrained.py::export_torch_state_dict``) loads too, as a
checkpoint at step 0. The JAX package's ``.msgpack`` checkpoints need flax
to read; they raise with a pointer to that exporter.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch


def _atomic_save(payload, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_model_checkpoint(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    global_step: int = 0,
    eval_loss: float = float("nan"),
    avg_auc: float = float("nan"),
) -> None:
    payload = {
        "global_step": int(global_step),
        "eval_loss": float(eval_loss),
        "avg_auc": float(avg_auc),
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
    }
    _atomic_save(payload, path)


def refuse_msgpack(path: str) -> None:
    """Raise for a JAX (flax msgpack) checkpoint, naming the exporter."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: a JAX (flax msgpack) checkpoint cannot be read by the PyTorch "
            "port; convert it with chexpert_tpu.models.pretrained."
            "export_torch_state_dict(params, batch_stats, arch, 'model.pth') on a "
            "host with JAX and restore the .pth")


def load_model_checkpoint(path: str) -> Dict:
    refuse_msgpack(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and isinstance(raw.get("state_dict"), dict):
        return {
            "global_step": int(raw.get("global_step", 0)),
            "eval_loss": float(raw.get("eval_loss", float("nan"))),
            "avg_auc": float(raw.get("avg_auc", float("nan"))),
            "state_dict": raw["state_dict"],
        }
    return {"global_step": 0, "eval_loss": float("nan"), "avg_auc": float("nan"),
            "state_dict": raw}


def save_optim_checkpoint(path: str, optimizer: torch.optim.Optimizer, scheduler,
                          generator: Optional[torch.Generator] = None) -> None:
    payload = {"optimizer": optimizer.state_dict(), "scheduler": scheduler.state_dict()}
    if generator is not None:
        payload["generator"] = generator.get_state()
    _atomic_save(payload, path)


def load_optim_checkpoint(path: str, optimizer: torch.optim.Optimizer, scheduler,
                          generator: Optional[torch.Generator] = None) -> None:
    """Load the state saved by ``save_optim_checkpoint`` into ``optimizer``,
    ``scheduler`` and, when both the file and the call have one,
    ``generator`` (tensors move to the parameters' device)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(raw["optimizer"])
    scheduler.load_state_dict(raw["scheduler"])
    if generator is not None and "generator" in raw:
        generator.set_state(raw["generator"])
