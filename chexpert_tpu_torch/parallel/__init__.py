"""Multi-process training of the port: one process per device under
``torch.distributed`` (counterpart of chexpert_tpu/parallel/).

  * ``multihost`` — the launch contract (torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; SLURM and Open MPI
    sizes count as a configured cluster too), ``initialize``, rank and
    primary-process queries, the rank's device;
  * ``mesh`` — the (data, model) grid of ranks, its process groups and
    collectives (gathered eval rows, member sums), and the rank's contiguous
    slice of the global batch;
  * ``sync_bn`` — BatchNorm whose training statistics are reduced over the
    data group, so a sharded batch normalizes as the global batch does (the
    JAX BatchNorm under a data-sharded batch reduces over the global batch).

The JAX package's ``parallel/context.py`` (the active mesh that the Pallas
attention wrappers read) and the ``shard_map`` branches of its kernels have
no counterpart: under DistributedDataParallel each rank runs its kernels on
its own slice of the batch, on its own device, so no kernel sees a mesh.
"""

from chexpert_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_hybrid_mesh,
    create_mesh,
    host_batch_slice_from_mesh,
)
from chexpert_tpu_torch.parallel.sync_bn import GlobalBatchNorm2d, convert_global_batchnorm

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_hybrid_mesh",
    "create_mesh",
    "host_batch_slice_from_mesh",
    "GlobalBatchNorm2d",
    "convert_global_batchnorm",
]
