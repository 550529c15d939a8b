"""PyTorch / CUDA port of chexpert_tpu for NVIDIA Hopper (H100).

The JAX package ``chexpert_tpu`` is the reference this port is held
against; this package never imports it (nor jax/flax/optax/pandas), so it
installs and runs on a GPU host without JAX. Module names mirror the JAX
package's so each counterpart is easy to find:

  * ``kernels`` — builds ``csrc/*.cu`` with nvcc at first use, loads it with
    ctypes, and counts kernel launches;
  * ``ops`` — the attention math (einsum ground truth, the query-side pack)
    and the wrappers of the hand-written kernels with the autograd functions
    joining them: relative-position attention in two layouts (B1 / B2,
    B5 / B6) and the depthwise conv (B3 / B4);
  * ``models`` — DenseNet / AA-DenseNet, ResNet / AA-ResNet and EfficientNet
    as NCHW ``nn.Module``s, the registry with its per-arch optimizer specs,
    and the weight carry-over from the JAX parameter trees;
  * ``configs``, ``data``, ``eval``, ``utils`` — the run config, the CheXpert
    index (csv; test mode for predict), transforms, synthetic fixture and
    batch pipeline, metrics and the N-checkpoint ensemble, JSON / scalar
    logging;
  * ``interpret`` — Grad-CAM, attention-weight capture and the matplotlib
    artifacts (vis grids, attention maps, ROC / PR plots);
  * ``train`` — loss, optimizers and schedules, train / eval steps, loops;
  * ``checkpoint`` — atomic ``.pt`` model and optimizer state, best-K tracker;
  * ``parallel`` — multi-process training, one process per device under
    ``torch.distributed``: launch, the grid of ranks, the global BatchNorm;
  * ``cli.chexpert`` (train / evaluate / ensemble / visualize / plot ROC),
    ``cli.predict`` (per-study probabilities csv) and ``cli.serve`` (HTTP
    inference).

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
