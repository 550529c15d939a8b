"""The (data, model) grid of ranks (counterpart of chexpert_tpu/parallel/
mesh.py and of the mesh half of chexpert_tpu/parallel/multihost.py).

One process owns one device, so the JAX mesh of devices becomes a grid of
ranks: rank ``r`` sits at ``(r // model_parallel, r % model_parallel)``, the
row-major reshape of JAX's ``create_hybrid_mesh``. A data row holds the ranks
that see the same rows of the global batch; a model column holds one rank of
each data row. Two process groups follow from the grid:

  * the data group, the ranks of the rank's model column: BatchNorm
    statistics are reduced and eval rows gathered over it, so every example
    counts once;
  * the model group, the ranks of the rank's data row: the ensemble splits
    its members over it and sums their outputs over it.

Gradients are averaged by DistributedDataParallel over all ranks; the
ranks of one data row hold equal gradients, so that mean is the mean over
the data rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from chexpert_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    data_parallel: int
    model_parallel: int
    rank: int = 0
    # process groups of the rank's model column and data row; None where the
    # axis has one rank (no collective runs over it)
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_parallel, MODEL_AXIS: self.model_parallel}

    @property
    def world(self) -> int:
        return self.data_parallel * self.model_parallel

    @property
    def data_index(self) -> int:
        """The rank's data row."""
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        """The rank's model column."""
        return self.rank % self.model_parallel

    def connect(self) -> "Mesh":
        """This mesh with the process groups of its rank. Every rank must
        call it, in the same order: each group is made by every rank."""
        dp, mp = self.data_parallel, self.model_parallel
        if self.world == 1:
            return self
        if dp == self.world:
            return dataclasses.replace(self, data_group=dist.group.WORLD)
        if mp == self.world:
            return dataclasses.replace(self, model_group=dist.group.WORLD)
        data_group = model_group = None
        for col in range(mp):
            group = dist.new_group([row * mp + col for row in range(dp)])
            if col == self.model_index:
                data_group = group
        for row in range(dp):
            group = dist.new_group([row * mp + col for col in range(mp)])
            if row == self.data_index:
                model_group = group
        return dataclasses.replace(self, data_group=data_group, model_group=model_group)

    def gather_batches(self, arrays: Sequence[np.ndarray], batch_rows: int) -> List[np.ndarray]:
        """All-gather over the data group the rank's rows of each array, which
        hold ``batch_rows`` rows of every global batch in turn, and return them
        in the order of the global batches (the one-process order). Every
        rank gets the same arrays; each rank passes the same shapes."""
        if self.data_group is None:
            return list(arrays)
        flat = [np.asarray(a, np.float32).reshape(len(a), -1) for a in arrays]
        local = torch.from_numpy(np.concatenate(flat, axis=1)).to(
            _collective_device(self.data_group))
        parts = [torch.empty_like(local) for _ in range(self.data_parallel)]
        dist.all_gather(parts, local, group=self.data_group)
        full = torch.stack(parts).cpu().numpy()  # (data rows, rows, columns)
        n_batches = local.shape[0] // batch_rows
        full = full.reshape(self.data_parallel, n_batches, batch_rows, -1)
        full = full.transpose(1, 0, 2, 3).reshape(-1, full.shape[-1])
        out, col = [], 0
        for a, f in zip(arrays, flat):
            out.append(full[:, col:col + f.shape[1]].reshape(-1, *np.shape(a)[1:])
                       .astype(np.asarray(a).dtype))
            col += f.shape[1]
        return out

    def sum_over_model(self, array: np.ndarray) -> np.ndarray:
        """The sum of ``array`` over the ranks of the data row."""
        if self.model_group is None:
            return array
        t = torch.from_numpy(np.ascontiguousarray(array)).to(
            _collective_device(self.model_group))
        dist.all_reduce(t, group=self.model_group)
        return t.cpu().numpy()

    def mean_over_data(self, value: float) -> float:
        """The mean of ``value`` over the data rows (a loss of the rank's
        slice becomes the loss of the global batch)."""
        if self.data_group is None:
            return value
        t = torch.tensor([value], dtype=torch.float64,
                         device=_collective_device(self.data_group))
        dist.all_reduce(t, group=self.data_group)
        return float(t) / self.data_parallel


def _collective_device(group) -> torch.device:
    """Where host values go for a collective of ``group``: the current card
    for NCCL, which reduces device memory only, and the host for gloo."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(data_parallel: int = 0, model_parallel: int = 1) -> Mesh:
    """The mesh of one process, which drives one device: JAX's
    ``create_mesh`` over that device, with its assertions (``data_parallel``
    0 means all the devices on the data axis)."""
    n = 1
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel <= 0:
        assert n % model_parallel == 0, (n, model_parallel)
        data_parallel = n // model_parallel
    use = data_parallel * model_parallel
    assert use <= n, f"mesh {data_parallel}x{model_parallel} needs {use} devices, have {n}"
    return Mesh(data_parallel, model_parallel)


def create_hybrid_mesh(data_parallel: int = 0, model_parallel: int = 1,
                       world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The (data, model) grid over all ranks, ``world`` and ``rank`` read from
    the process group unless given; no process group is made here
    (``Mesh.connect``). ``data_parallel`` 0 means ``world // model_parallel``.
    Under ``world > 1`` the grid must cover every rank; one process is
    ``create_mesh``."""
    world = multihost.world_size() if world is None else world
    rank = multihost.rank() if rank is None else rank
    if world == 1:
        return create_mesh(data_parallel, model_parallel)
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel <= 0:
        assert world % model_parallel == 0
        data_parallel = world // model_parallel
    assert data_parallel * model_parallel == world, (
        f"data_parallel*model_parallel = {data_parallel * model_parallel} "
        f"must equal the global device count {world} in multihost mode"
    )
    return Mesh(data_parallel, model_parallel, rank)


def host_batch_slice_from_mesh(mesh: Mesh, global_batch_size: int) -> slice:
    """The rank's contiguous rows of each global batch: those of its data
    row; the ranks of one data row load the same rows. JAX's assertion that
    a data row does not span processes cannot trigger here: a process owns
    one device, and each rank of a row loads the row's slice itself."""
    dp = mesh.data_parallel
    assert global_batch_size % dp == 0, (global_batch_size, dp)
    per_row = global_batch_size // dp
    return slice(mesh.data_index * per_row, (mesh.data_index + 1) * per_row)
