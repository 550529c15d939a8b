"""Data layer of the port: the CheXpert index (csv), host-side transforms,
the synthetic fixture and the batch pipeline."""

from chexpert_tpu_torch.data.chexpert import (
    ATTR_ALL_NAMES,
    ATTR_NAMES,
    DIR_NAME,
    PIXEL_MEAN,
    PIXEL_STD,
    ChexpertIndex,
    extract_patient_ids,
)
from chexpert_tpu_torch.data.pipeline import Batches, device_prefetch
from chexpert_tpu_torch.data.synthetic import make_synthetic_dataset
from chexpert_tpu_torch.data.transforms import decode_transform, denormalize, expand_channels

__all__ = [
    "ATTR_ALL_NAMES",
    "ATTR_NAMES",
    "DIR_NAME",
    "PIXEL_MEAN",
    "PIXEL_STD",
    "ChexpertIndex",
    "extract_patient_ids",
    "Batches",
    "device_prefetch",
    "make_synthetic_dataset",
    "decode_transform",
    "denormalize",
    "expand_channels",
]
