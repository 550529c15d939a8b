"""PyTorch / CUDA port of chexpert_tpu for NVIDIA Hopper (H100).

The JAX package ``chexpert_tpu`` is the reference this port is held
against; this package never imports it (nor jax/flax/optax), so it installs
and runs on a GPU host without JAX. Module names mirror the JAX package's so
each counterpart is easy to find:

  * ``kernels`` — builds ``csrc/*.cu`` with nvcc at first use, loads it with
    ctypes, and counts kernel launches;
  * ``ops`` — the attention math (einsum ground truth, the query-side pack)
    and the hand-written relative-position attention kernel's wrapper;
  * ``models`` — DenseNet / AA-DenseNet as NCHW ``nn.Module``s, the
    registry, and the weight carry-over from the JAX parameter trees;
  * ``checkpoint`` — atomic ``.pt`` state-dict storage;
  * ``cli.serve`` — the HTTP inference server.

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
