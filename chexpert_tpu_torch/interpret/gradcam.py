"""Grad-CAM with a forward hook (port of chexpert_tpu/interpret/gradcam.py).

Each model names its Grad-CAM site (``gradcam_site``: DenseNet's
``features.norm5`` output before the ReLU, ResNet's ``layer4`` output,
EfficientNet's ``head_bn`` output before the swish), the module at which the
JAX models sow ``gradcam_features``. The forward runs without autograd up to
the site; a forward hook there returns the site's output detached, as a leaf
that requires grad (the counterpart of JAX's ``probe``), and turns autograd
on for the rest of the forward. So only the head (activation, pool, linear)
is recorded, ``torch.autograd.grad`` of the chosen class's logit w.r.t. the
leaf is the one reverse pass, and every kernel upstream of the site runs its
forward alone: Grad-CAM launches no backward kernel.

Exact Grad-CAM (eq. 1-2 of https://arxiv.org/pdf/1610.02391.pdf), in f32:
  weights_c = spatial mean of d(score) / d(feature_c)
  cam = ReLU(sum_c weights_c * feature_c), min-max normalized per image
  (reference chexpert.py:288-294), bilinearly upsampled to the input size
  with half-pixel centers (``align_corners=False``, the rule of
  ``jax.image.resize(..., "bilinear")`` for upsampling).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from chexpert_tpu_torch.train.steps import autocast


def site_forward(model: torch.nn.Module, x: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One eval forward of ``model`` on ``x`` (B, 3, H, W): (f32 logits, the
    Grad-CAM site's output as a leaf that requires grad), with autograd
    recording only what follows the site."""
    site = model.get_submodule(model.gradcam_site)
    found = {}

    def hook(module, inputs, out):
        feats = out.detach().requires_grad_()
        found["feats"] = feats
        torch.set_grad_enabled(True)  # the enclosing no_grad restores the mode on exit
        return feats

    handle = site.register_forward_hook(hook)
    was_training = model.training
    try:
        with torch.no_grad(), autocast(x.device, compute_dtype):
            logits = model.eval()(x).float()
    finally:
        handle.remove()
        model.train(was_training)
    return logits, found["feats"]


def grad_cam(model: torch.nn.Module, x: torch.Tensor, cls_idx=None,
             compute_dtype: torch.dtype = torch.float32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cam (B, 1, H, W) f32 in [0, 1], logits (B, C) f32) for the input
    ``x`` (B, 3, H, W); the class is the argmax of each image's logits, or
    ``cls_idx`` (an int, or one per image)."""
    logits, feats = site_forward(model, x, compute_dtype)
    B, n_classes = logits.shape
    if cls_idx is None:
        cls = logits.argmax(dim=1)
    else:
        cls = torch.broadcast_to(torch.as_tensor(cls_idx, device=logits.device), (B,))
    one_hot = F.one_hot(cls.long(), n_classes).to(logits.dtype)
    (grads,) = torch.autograd.grad((logits * one_hot).sum(), feats)
    with torch.no_grad(), torch.autocast(x.device.type, enabled=False):
        f, g = feats.detach().float(), grads.float()
        weights = g.mean(dim=(2, 3), keepdim=True)                 # (B, C, 1, 1)
        cam = F.relu((weights * f).sum(dim=1, keepdim=True))       # (B, 1, h, w)
        mn = cam.amin(dim=(1, 2, 3), keepdim=True)
        mx = cam.amax(dim=(1, 2, 3), keepdim=True)
        cam = (cam - mn) / (mx - mn + 1e-5)
        cam = F.interpolate(cam, size=tuple(x.shape[2:]), mode="bilinear",
                            align_corners=False)
    return cam, logits.detach()
