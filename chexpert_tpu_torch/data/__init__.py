"""Data constants and host-side image transforms of the port."""

from chexpert_tpu_torch.data.chexpert import ATTR_NAMES, PIXEL_MEAN, PIXEL_STD

__all__ = ["ATTR_NAMES", "PIXEL_MEAN", "PIXEL_STD"]
