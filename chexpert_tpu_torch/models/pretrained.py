"""ImageNet-pretrained weights from a torchvision state-dict file (port of
chexpert_tpu/models/pretrained.py::load_pretrained).

The reference takes them from torchvision's model zoo (``pretrained=True``).
With no network, the file is fetched out of band and named by the arch:

    CHEXPERT_TPU_PRETRAINED_DIR=/path/with/{densenet121,resnet152,...}.pth

Keys go through ``convert.normalize_state_dict`` (the legacy ``norm.1`` /
``conv.2`` DenseNet keys, the ``features.`` prefix); the classifier head is
skipped, since the reference replaces it with a fresh 5-way layer; every
other parameter and statistic of the model must be in the file.
"""

from __future__ import annotations

import os

import torch

from chexpert_tpu_torch.models.convert import normalize_state_dict

PRETRAINED_DIR_ENV = "CHEXPERT_TPU_PRETRAINED_DIR"
_HEADS = ("classifier.", "fc.")


def _is_head(key: str) -> bool:
    return any(key.startswith(h) or f".{h}" in key for h in _HEADS)


@torch.no_grad()
def load_pretrained(model: torch.nn.Module, arch: str) -> int:
    """Load ``arch``'s pretrained weights into ``model`` in place, the head
    excepted; returns the number of tensors loaded. Raises
    FileNotFoundError with the JAX package's text when the file is not
    there, and KeyError for a key of the file the model lacks, or a tensor
    of the model (head and ``num_batches_tracked`` excepted) the file lacks."""
    d = os.environ.get(PRETRAINED_DIR_ENV, "")
    path = os.path.join(d, f"{arch}.pth")
    if not d or not os.path.exists(path):
        raise FileNotFoundError(
            f"--pretrained requires a torchvision state dict at "
            f"${PRETRAINED_DIR_ENV}/{arch}.pth (no network egress in this "
            "environment); proceeding without it is the --no-pretrained path")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    sd = {k: v for k, v in normalize_state_dict(sd, arch).items() if not _is_head(k)}
    own = model.state_dict()
    unknown = [k for k in sd if k not in own]
    missing = [k for k in own if k not in sd and not _is_head(k)
               and not k.endswith("num_batches_tracked")]
    if unknown or missing:
        raise KeyError(f"{arch}.pth does not match the model: {len(unknown)} keys it lacks "
                       f"(e.g. {unknown[:5]}), {len(missing)} of its tensors missing "
                       f"(e.g. {missing[:5]})")
    model.load_state_dict(sd, strict=False)
    return len(sd)
