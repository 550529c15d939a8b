from chexpert_tpu_torch.utils.io import load_json, resolve_device, save_json
from chexpert_tpu_torch.utils.logging import MetricsWriter

__all__ = ["load_json", "resolve_device", "save_json", "MetricsWriter"]
