"""PyTorch / CUDA port of chexpert_tpu for NVIDIA Hopper (H100).

The JAX package ``chexpert_tpu`` is the reference this port is held
against; this package never imports it (nor jax/flax/optax/pandas), so it
installs and runs on a GPU host without JAX. Module names mirror the JAX
package's so each counterpart is easy to find:

  * ``kernels`` — builds ``csrc/*.cu`` with nvcc at first use, loads it with
    ctypes, and counts kernel launches;
  * ``ops`` — the attention math (einsum ground truth, the query-side pack)
    and the hand-written relative-position attention kernels' wrappers:
    forward (B1), backward (B2) and the autograd function joining them;
  * ``models`` — DenseNet / AA-DenseNet as NCHW ``nn.Module``s, the
    registry with its per-arch optimizer specs, and the weight carry-over
    from the JAX parameter trees;
  * ``configs``, ``data``, ``eval``, ``utils`` — the run config, the CheXpert
    index (csv), transforms, synthetic fixture and batch pipeline, metrics,
    JSON / scalar logging;
  * ``train`` — loss, optimizers and schedules, train / eval steps, loops;
  * ``checkpoint`` — atomic ``.pt`` model and optimizer state, best-K tracker;
  * ``cli.chexpert`` (train / evaluate) and ``cli.serve`` (HTTP inference).

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
