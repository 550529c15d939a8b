"""Multi-process launch (counterpart of chexpert_tpu/parallel/multihost.py).

One process drives one device. Every process runs the same command, e.g.

    torchrun --nproc_per_node N -m chexpert_tpu_torch.cli.chexpert --train \\
        --multihost --output_dir D ...

and ``initialize`` joins them into one ``torch.distributed`` group from the
launcher's environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (or SLURM's
``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_LOCALID``, or Open MPI's
``OMPI_COMM_WORLD_*``), with the rendezvous at ``MASTER_ADDR``:``MASTER_PORT``.
The backend is NCCL for a CUDA device and gloo for the CPU.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

# (rank, size, local rank) variables of each launcher, in the order read
_LAUNCHERS = (
    ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
)


def cluster_env_configured() -> bool:
    """True when the environment asks for a multi-process run: a launcher's
    size above 1, or ``MASTER_ADDR`` beside a ``WORLD_SIZE`` (torchrun sets
    both, also for one process). If so, a failed init is a broken launch, and
    running on as one process would let N trainers race on one output_dir
    behind the primary-only writes. Single-host values (``SLURM_NTASKS=1``,
    ``WORLD_SIZE=1`` alone) do not count."""
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        return True
    for _, size, _ in _LAUNCHERS:
        try:
            if int(os.environ.get(size, "")) > 1:
                return True
        except ValueError:
            pass
    return False


def launch_env() -> Tuple[int, int, int]:
    """(rank, world size, local rank): torchrun's variables when
    ``WORLD_SIZE`` is set (also to 1), else those of the first launcher
    whose size is above 1, else (0, 1, 0)."""
    for i, (rank_var, size_var, local_var) in enumerate(_LAUNCHERS):
        size = os.environ.get(size_var)
        if size and (i == 0 or int(size) > 1):
            return (int(os.environ.get(rank_var, "0")), int(size),
                    int(os.environ.get(local_var, "0")))
    return 0, 1, 0


def initialize(device: torch.device) -> bool:
    """Join the process group of a configured launch; returns whether this
    call created the group (the caller then destroys it).

    A no-op when a group is already up (a launcher or the caller made it) or
    when nothing in the environment configures a cluster: the one-process
    case. When a cluster is configured, a failed init raises."""
    if dist.is_initialized() or not cluster_env_configured():
        return False
    rank_, world, _ = launch_env()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", rank=rank_, world_size=world)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes the run's artifacts (rank 0). Every
    rank computes the same metrics (eval gathers), so the others would only
    race on the same files."""
    return rank() == 0


def local_device(device: torch.device) -> torch.device:
    """The process's device: ``cuda:{LOCAL_RANK}`` for a ``cuda`` device
    without an index (``cuda:0`` when no launcher sets a local rank);
    anything else as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", launch_env()[2])


def barrier() -> None:
    """Wait for every rank (nothing to wait for in one process)."""
    if dist.is_initialized():
        dist.barrier()
