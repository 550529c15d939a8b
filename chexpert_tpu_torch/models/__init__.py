from chexpert_tpu_torch.models.attn import AAConv2d, attn_dims
from chexpert_tpu_torch.models.convert import normalize_state_dict, state_dict_from_jax
from chexpert_tpu_torch.models.densenet import AttnParams, DenseNet
from chexpert_tpu_torch.models.efficientnet import EfficientNet
from chexpert_tpu_torch.models.resnet import ResNet, WideResNet
from chexpert_tpu_torch.models.registry import (
    N_CLASSES,
    OptimizerSpec,
    build_model,
    optimizer_spec,
)

__all__ = [
    "AAConv2d",
    "attn_dims",
    "normalize_state_dict",
    "state_dict_from_jax",
    "AttnParams",
    "DenseNet",
    "EfficientNet",
    "ResNet",
    "WideResNet",
    "N_CLASSES",
    "OptimizerSpec",
    "build_model",
    "optimizer_spec",
]
