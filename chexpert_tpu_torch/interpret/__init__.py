"""Interpretability: Grad-CAM (a forward hook at each model's site),
attention-weight capture (the einsum route, chunked over the batch) and the
matplotlib artifacts (vis grids, attention maps, ROC/PR plots; matplotlib is
imported only when one is rendered)."""

from chexpert_tpu_torch.interpret.capture import attention_layers, capture_attention_weights
from chexpert_tpu_torch.interpret.gradcam import grad_cam, site_forward
from chexpert_tpu_torch.interpret.plots import plot_roc, save_attn_maps, save_vis_grids

__all__ = ["attention_layers", "capture_attention_weights", "grad_cam", "plot_roc",
           "save_attn_maps", "save_vis_grids", "site_forward"]
