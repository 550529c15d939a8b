"""BatchNorm over the global batch of a data-parallel run.

The JAX BatchNorm under a data-sharded batch reduces its statistics over
the global batch (chexpert_tpu/models/common.py); per-rank statistics would
change every number of a run. ``GlobalBatchNorm2d`` is an ``nn.BatchNorm2d``
(the same parameters, buffers and state-dict keys) whose training forward
all-reduces over the data group the per-channel sum and count, then the sum
of squared deviations from the global mean, and normalizes with plain
tensor ops, on the CPU and on the card alike (``nn.SyncBatchNorm`` refuses
CPU tensors). The variance takes two passes, as torch's BatchNorm computes
it: the one-pass sum of squares minus the squared mean cancels in float32
where the mean is large beside the spread (mean^2 / var reaches 25 on the AA
transitions' outputs). The all-reduces are differentiable: their backward
sums the statistics' gradients over the group, so each rank's input
gradient is that of the global batch.

The data group holds one rank of each data row: the ranks of one row see the
same examples, and reducing over them would count each example
``model_parallel`` times. The running variance is torch's unbiased one, with
n the global count. Eval mode uses the running statistics, as
``nn.BatchNorm2d`` does.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch import nn


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, tensor: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Shared:
    """Holds a process group for a module; a copy of the module (the
    ensemble's members are deep copies) shares it: a group cannot be copied."""

    def __init__(self, group: Any):
        self.group = group

    def __deepcopy__(self, memo) -> "_Shared":
        return self


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training statistics span ``group``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, track_running_stats: bool = True, group: Any = None):
        super().__init__(num_features, eps, momentum, affine, track_running_stats)
        self._group = _Shared(group)

    @property
    def group(self) -> Any:
        return self._group.group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        shape = (1, c, 1, 1)
        x32 = x.float()
        total = _SumOverGroup.apply(
            torch.cat([x32.sum(dim=(0, 2, 3)), x32.new_full((1,), x32.numel() // c)]),
            self.group)
        n = total[c]
        mean = total[:c] / n
        centered = x32 - mean.view(shape)
        var = _SumOverGroup.apply((centered * centered).sum(dim=(0, 2, 3)), self.group) / n
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                          else self.momentum)
                self.running_mean.mul_(1 - factor).add_(mean, alpha=factor)
                self.running_var.mul_(1 - factor).add_(var * n / (n - 1), alpha=factor)
        y = centered * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def convert_global_batchnorm(module: nn.Module, group: Any) -> nn.Module:
    """``module`` with every ``nn.BatchNorm2d`` replaced by a
    ``GlobalBatchNorm2d`` over ``group`` that holds the same parameter and
    buffer tensors (an optimizer made after the call sees the same
    parameters; the state dict is unchanged)."""
    if isinstance(module, nn.BatchNorm2d) and not isinstance(module, GlobalBatchNorm2d):
        new = GlobalBatchNorm2d(module.num_features, module.eps, module.momentum,
                                module.affine, module.track_running_stats, group)
        if module.affine:
            new.weight, new.bias = module.weight, module.bias
        if module.track_running_stats:
            new.running_mean = module.running_mean
            new.running_var = module.running_var
            new.num_batches_tracked = module.num_batches_tracked
        return new.train(module.training)
    for name, child in module.named_children():
        new_child = convert_global_batchnorm(child, group)
        if new_child is not child:
            setattr(module, name, new_child)
    return module
