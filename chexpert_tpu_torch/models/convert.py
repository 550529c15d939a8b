"""Weight carry-over into the port's state dict.

  * ``state_dict_from_jax(params, batch_stats, arch)``: the JAX package's
    Flax trees (nested dicts of numpy arrays) -> the port's ``state_dict``:
    conv HWIO -> OIHW (a depthwise (k, k, 1, C) kernel becomes (C, 1, k, k)),
    Dense (in, out) -> (out, in), BN scale/bias/mean/var ->
    weight/bias/running_mean/running_var (plus the ``num_batches_tracked``
    buffers strict loading needs), ``key_rel_*`` unchanged; the Flax path
    joined by dots, with the DenseNet family's body under ``features.`` and
    the ResNet family's ``downsample_conv`` / ``downsample_bn`` as
    torchvision's ``downsample.0`` / ``downsample.1``.
  * ``normalize_state_dict(sd, arch)``: a torchvision-format state dict,
    e.g. one written by the JAX package's
    ``models/pretrained.py::export_torch_state_dict`` -> the port's keys. That
    exporter writes no ``features.`` prefix for ``aadensenet*`` archs and no
    ``num_batches_tracked``; old torchvision zoo files use ``norm.1`` /
    ``conv.2`` style dense-layer keys. EfficientNet keys are the Flax paths
    (``blocks_3_1.depthwise_conv.weight``) in both and stay as they are,
    and so do the ResNet family's, which the exporter already writes as
    torchvision names them.

``arch`` is the registry name; ``normalize_state_dict`` renames only the
DenseNet family (a name containing ``densenet``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_HEADS = ("classifier",)
_RESNET_DOWNSAMPLE = {"downsample_conv": ("downsample", "0"),
                      "downsample_bn": ("downsample", "1")}
_LEGACY = re.compile(r"^(.*denselayer\d+\.(?:norm|relu|conv))\.([12])\.(.*)$")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _key(path: tuple, leaf: str) -> str:
    parts = []
    for name in path:
        parts += _RESNET_DOWNSAMPLE.get(name, (name,))
    return ".".join((*parts, leaf))


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        arch: str = "densenet121") -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}
    for p, val in _flatten(params).items():
        val = np.array(val, dtype=np.float32)  # a writable copy
        path, leaf = p[:-1], p[-1]
        if leaf == "kernel" and val.ndim == 4:
            sd[_key(path, "weight")] = val.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and val.ndim == 2:
            sd[_key(path, "weight")] = val.T
        elif leaf == "scale":
            sd[_key(path, "weight")] = val
        elif leaf in ("bias", "key_rel_h", "key_rel_w"):
            sd[_key(path, leaf)] = val
        else:
            raise KeyError(f"unhandled JAX parameter {'/'.join(p)} of shape {val.shape}")
    for p, val in _flatten(batch_stats).items():
        val = np.array(val, dtype=np.float32)
        path, leaf = p[:-1], p[-1]
        if leaf == "mean":
            sd[_key(path, "running_mean")] = val
        elif leaf == "var":
            sd[_key(path, "running_var")] = val
        else:
            raise KeyError(f"unhandled JAX batch statistic {'/'.join(p)}")
    return normalize_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in sd.items()}, arch)


def normalize_state_dict(sd: Mapping[str, torch.Tensor],
                         arch: str = "densenet121") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if "densenet" in arch:
            m = _LEGACY.match(k)
            if m:
                k = m.group(1) + m.group(2) + "." + m.group(3)
            if not k.startswith("features.") and k.split(".", 1)[0] not in _HEADS:
                k = "features." + k
        out[k] = v
    for k in list(out):
        if k.endswith(".running_mean"):
            nbt = k[: -len("running_mean")] + "num_batches_tracked"
            out.setdefault(nbt, torch.tensor(0, dtype=torch.long))
    return out
