"""Multi-process helpers of the port's tests (CPU, gloo).

``launch`` starts ``world`` processes of one command under the torchrun
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
returns their results. Run as a script, this file is one rank of the global
BatchNorm check:

    python tests/_torch_dist_worker.py bn OUT_PREFIX MODEL_PARALLEL

Each rank builds the same seeded global batch, takes its data row's slice,
runs ``GlobalBatchNorm2d`` forward and backward on it (upstream gradient
seeded too) and saves its output, input gradient, parameter gradients and
running statistics to ``OUT_PREFIX{rank}.npz``. Or one rank of the index
check:

    python tests/_torch_dist_worker.py index OUT_PREFIX DATA_ROOT

where the ranks, released together by a barrier, build ``ChexpertIndex``
over a fixture with no processed cache yet and save the train and valid
lengths and paths to ``OUT_PREFIX{rank}.json``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BN_SHAPE = (2, 4, 3, 3)  # one data row's slice: (B, C, H, W)
BN_MOMENTUM = 0.1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, argv: Sequence[str], cwd: str, timeout: float = 300
           ) -> List[subprocess.CompletedProcess]:
    """Run ``python argv`` as ``world`` ranks on the CPU; waits for all. Each
    rank writes to files, not pipes: a rank blocked on a full pipe would
    hold the others in their next collective."""
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
            logs.append((tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, text=True,
                                          stdout=logs[-1][0], stderr=logs[-1][1]))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append(subprocess.CompletedProcess(p.args, p.returncode, out.read(),
                                                       err.read()))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def bn_global_batch(dp: int):
    """(x, upstream gradient, weight, bias) of the check, float64, seeded."""
    rng = np.random.RandomState(0)
    b, c, h, w = BN_SHAPE
    x = rng.randn(dp * b, c, h, w) * rng.uniform(0.5, 2.0, (1, c, 1, 1)) + rng.randn(1, c, 1, 1)
    g = rng.randn(dp * b, c, h, w)
    return x, g, 1.0 + 0.1 * rng.randn(c), 0.1 * rng.randn(c)


def _bn_rank(prefix: str, model_parallel: int) -> None:
    import torch

    from chexpert_tpu_torch.parallel import (
        GlobalBatchNorm2d,
        create_hybrid_mesh,
        host_batch_slice_from_mesh,
        multihost,
    )

    multihost.initialize(torch.device("cpu"))
    mesh = create_hybrid_mesh(0, model_parallel).connect()
    x, g, weight, bias = bn_global_batch(mesh.data_parallel)
    rows = host_batch_slice_from_mesh(mesh, len(x))
    bn = GlobalBatchNorm2d(BN_SHAPE[1], momentum=BN_MOMENTUM, group=mesh.data_group)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xr = torch.tensor(x[rows], dtype=torch.float32, requires_grad=True)
    y = bn.train()(xr)
    y.backward(torch.tensor(g[rows], dtype=torch.float32))
    np.savez(f"{prefix}{mesh.rank}.npz", y=y.detach().numpy(), dx=xr.grad.numpy(),
             dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
             running_mean=bn.running_mean.numpy(), running_var=bn.running_var.numpy(),
             rows=np.array([rows.start, rows.stop]), data_index=mesh.data_index)
    torch.distributed.destroy_process_group()


def _index_rank(prefix: str, root: str) -> None:
    import json

    import torch

    from chexpert_tpu_torch.data import ChexpertIndex
    from chexpert_tpu_torch.parallel import multihost

    multihost.initialize(torch.device("cpu"))
    torch.distributed.barrier()
    out = {}
    for mode in ("train", "valid"):
        index = ChexpertIndex(root, mode)
        out[mode] = [index.path(i) for i in range(len(index))]
    with open(f"{prefix}{multihost.rank()}.json", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "bn":
        _bn_rank(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "index":
        _index_rank(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
