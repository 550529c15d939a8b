"""N-checkpoint ensemble evaluation (port of chexpert_tpu/eval/ensemble.py).

The JAX package stacks the K members' parameters and vmaps one forward over
them. The port's attention and depthwise kernels are ctypes launches, which
``torch.func.vmap`` cannot batch, so a member group here is a list of
modules on the device (one ``copy.deepcopy`` of the built model per member,
loaded from its checkpoint, in eval mode), and each valid batch moves to the
device once and runs through the group's members in turn.

Score combination as in the reference (chexpert.py:217-236): per batch the
group's logits and per-element losses are summed on the device, added up on
the host as (N, 5) f32 over the groups and divided by K, and the metrics are
computed from those means. ``ensemble_outputs`` is the counterpart of the
JAX ``_evaluate_groups``, returning the means (which ``chip_smoke.py`` holds
against single-model passes); ``evaluate_ensemble`` computes the metrics.

Memory: the group size (``member_chunk``) is planned from the free device
memory (``_plan_member_chunk``), and a ``torch.cuda.OutOfMemoryError`` halves
it and retries. Members run in turn, so a group's activations do not grow
with its size: k members cost k times one member's parameter and buffer
bytes plus one member's peak activation bytes.

Multi-process (``mesh``): each rank evaluates its data row's slice of every
valid batch. When the model axis has more than one rank and divides the
member count, the members are split over it in contiguous blocks, as the
JAX ``member_sharding`` shards the stacked member axis
(``member_range``): each rank runs its own members, the sums of their
outputs and losses are all-reduced over the data row before the division
by K, and the data rows' rows are then gathered, as the JAX module's
allgather does. Otherwise every rank of a row runs every member. The
memory planner plans for the rank's own members.
"""

from __future__ import annotations

import copy
import gc
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from chexpert_tpu_torch.checkpoint import load_model_checkpoint, refuse_msgpack
from chexpert_tpu_torch.data.pipeline import Batches, device_prefetch
from chexpert_tpu_torch.eval.metrics import compute_metrics
from chexpert_tpu_torch.models.convert import normalize_state_dict
from chexpert_tpu_torch.parallel.mesh import Mesh
from chexpert_tpu_torch.train.loss import bce_with_logits
from chexpert_tpu_torch.train.steps import eval_logits, prepare_image


def list_checkpoints(restore_dir: str) -> List[str]:
    """checkpoint*.pt files in a directory, sorted by name (reference
    chexpert.py:218-219). A JAX checkpoint*.msgpack among them raises: the
    port cannot read it."""
    names = [c for c in sorted(os.listdir(restore_dir))
             if c.startswith("checkpoint") and (c.endswith(".msgpack") or c.endswith(".pt"))]
    paths = [os.path.join(restore_dir, c) for c in names]
    for p in paths:
        refuse_msgpack(p)
    return paths


def load_member(model: torch.nn.Module, path: str, arch: str) -> torch.nn.Module:
    """A copy of ``model`` (on its device) holding the weights of ``path``,
    in eval mode, without the gradients a trained ``model`` still holds."""
    member = copy.deepcopy(model)
    member.zero_grad(set_to_none=True)
    member.load_state_dict(normalize_state_dict(load_model_checkpoint(path)["state_dict"], arch),
                           strict=True)
    return member.eval()


def member_range(mesh: Optional[Mesh], n_members: int) -> range:
    """The members this rank runs: its model column's contiguous block when
    the model axis has more than one rank and divides ``n_members``, else
    all of them (the JAX ``member_sharding``)."""
    mp = 1 if mesh is None else mesh.model_parallel
    if mp > 1 and n_members % mp == 0:
        per = n_members // mp
        return range(mesh.model_index * per, (mesh.model_index + 1) * per)
    return range(n_members)


def _member_groups(n: int, chunk: int) -> List[range]:
    chunk = max(1, min(chunk, n))
    return [range(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _device_budget_bytes(device: torch.device) -> float:
    """Free device memory for planning, from ``torch.cuda.mem_get_info``:
    10% safety margin plus a 1 GiB reserve for prefetched batches, outputs
    and fragmentation. ``CHEXPERT_HBM_GB`` overrides the card's total (the
    memory in use stays what the card reports)."""
    free, total = torch.cuda.mem_get_info(device)
    env = os.environ.get("CHEXPERT_HBM_GB")
    if env:
        free = float(env) * 2**30 - (total - free)
    return 0.9 * free - 2**30


def _fit_member_chunk(n_members: int, budget: float, cost_of: Callable[[int], float]) -> int:
    """Largest member chunk whose footprint ``cost_of(k)`` fits ``budget``.
    After each shrink the chunk is re-balanced to ceil(n / passes), so the
    size checked is the size the passes use (the JAX package's search)."""
    chunk = n_members
    while True:
        cost = cost_of(chunk)
        if cost <= budget or chunk == 1:
            return chunk
        smaller = min(chunk - 1, max(1, int(chunk * budget / cost)))
        passes = -(-n_members // smaller)  # ceil
        chunk = -(-n_members // passes)


def member_bytes(model: torch.nn.Module) -> int:
    """Bytes of one member's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def _plan_member_chunk(model: torch.nn.Module, n_members: int, batches: Batches,
                       device: torch.device, compute_dtype: torch.dtype,
                       log=print) -> int:
    """The largest member chunk that fits the free device memory, before any
    member is loaded. One member's peak activation bytes are measured once,
    around a forward of ``model`` on the first batch; the host's memory pages,
    so the CPU returns ``n_members``."""
    if n_members == 1 or device.type != "cuda":
        return n_members
    batch = next(iter(batches))
    image = prepare_image(torch.from_numpy(batch["image"]).to(device))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    eval_logits(model, image, compute_dtype)
    torch.cuda.synchronize(device)
    activation = torch.cuda.max_memory_allocated(device) - base
    del image
    per_member = member_bytes(model)

    def cost_of(k: int) -> float:
        return float(k * per_member + activation)

    budget = _device_budget_bytes(device)
    chunk = _fit_member_chunk(n_members, budget, cost_of)
    log(f"[ensemble] planned member_chunk={chunk} of {n_members}: {per_member / 1e9:.3f} GB "
        f"per member, peak activation {activation / 1e9:.3f} GB, free-memory budget "
        f"{budget / 1e9:.1f} GB")
    return chunk


def ensemble_outputs(model: torch.nn.Module, paths: List[str], batches: Batches,
                     device: torch.device, compute_dtype: torch.dtype, chunk: int,
                     arch: str, timings: Optional[list] = None, mesh: Optional[Mesh] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One ensemble pass with the rank's members (``member_range``; all of
    ``paths`` in one process) evaluated ``chunk`` at a time: (the mean over
    the K members of the logits, the targets, the mean of the per-element
    losses) of the valid rows, each (N, 5), as ``compute_metrics`` takes them.

    Member groups outer, valid batches inner: device memory holds one group's
    members and one member's forward at a time. Several passes over the valid
    set are the reference's protocol (it re-runs the loader per checkpoint).
    ``timings``, when given, gets one dict per group: its members, batches and
    the seconds of its batch loop (loading excluded)."""
    K = len(paths)
    own = [paths[i] for i in member_range(mesh, K)]
    out_sum = loss_sum = targets = mask = None
    for gi, group in enumerate(_member_groups(len(own), chunk)):
        members = [load_member(model, own[i], arch) for i in group]
        outs, losses, tgts, msks = [], [], [], []
        t0 = time.perf_counter()
        for batch in device_prefetch(batches, device):
            image = prepare_image(batch["image"])
            o = l = None
            for member in members:  # the group's sums, on the device
                logits = eval_logits(member, image, compute_dtype)
                per_elem = bce_with_logits(logits, batch["label"])
                o = logits if o is None else o + logits
                l = per_elem if l is None else l + per_elem
            outs.append(o.cpu().numpy())
            losses.append(l.cpu().numpy())
            if gi == 0:
                tgts.append(batch["label"].cpu().numpy())
                msks.append(batch["mask"].cpu().numpy())
        if timings is not None:
            timings.append({"members": len(group), "batches": len(outs),
                            "seconds": time.perf_counter() - t0})
        del members  # freed before the next group loads
        o, l = np.concatenate(outs), np.concatenate(losses)
        out_sum = o if out_sum is None else out_sum + o
        loss_sum = l if loss_sum is None else loss_sum + l
        if gi == 0:
            targets, mask, batch_rows = np.concatenate(tgts), np.concatenate(msks), len(msks[0])
    rows = out_sum, targets, loss_sum, mask
    if mesh is not None:
        if len(own) < K:  # the members are split over the data row
            rows = mesh.sum_over_model(out_sum), targets, mesh.sum_over_model(loss_sum), mask
        rows = mesh.gather_batches(rows, batch_rows)
    keep = rows[3].astype(bool)
    return (rows[0] / K)[keep], rows[1][keep], (rows[2] / K)[keep]


def evaluate_ensemble(model: torch.nn.Module, paths: List[str], batches: Batches,
                      device: torch.device, compute_dtype: torch.dtype, arch: str,
                      member_chunk: int = 0, log=print, mesh: Optional[Mesh] = None) -> Dict:
    """Metrics of the K-member ensemble. ``member_chunk`` 0 plans the chunk
    from the free device memory (all of the rank's members on the CPU); on
    ``torch.cuda.OutOfMemoryError`` the chunk is halved and the pass
    retried. ``member_chunk`` > 0 pins the chunk and skips planning.
    ``model`` is the built model on ``device``: each member is a copy."""
    if not paths:
        raise AssertionError("no checkpoints found to ensemble")
    chunk = member_chunk or _plan_member_chunk(model, len(member_range(mesh, len(paths))),
                                               batches, device, compute_dtype, log)
    while True:
        try:
            return compute_metrics(*ensemble_outputs(model, paths, batches, device,
                                                     compute_dtype, chunk, arch, mesh=mesh))
        except torch.cuda.OutOfMemoryError:
            if chunk <= 1:
                raise
            chunk = (chunk + 1) // 2
        # outside the handler, so the failed attempt's frames (and the device
        # memory they hold) are gone before the collection
        log(f"[ensemble] device out of memory: retrying with member_chunk={chunk}")
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
