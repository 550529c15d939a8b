"""Attention math (plain torch) and the fused kernel's wrapper."""


def kernel_targets() -> list:
    """Every library the ops load, as (source, defines) targets of
    ``kernels.build``: the attention sources once per head-width class, the
    depthwise sources once."""
    from chexpert_tpu_torch.ops import depthwise, fused_attention

    return fused_attention.width_targets() + [(s, ()) for s in (depthwise.FWD, depthwise.BWD)]
