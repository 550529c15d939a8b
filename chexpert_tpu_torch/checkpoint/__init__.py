from chexpert_tpu_torch.checkpoint.store import (
    load_model_checkpoint,
    load_optim_checkpoint,
    refuse_msgpack,
    save_model_checkpoint,
    save_optim_checkpoint,
)
from chexpert_tpu_torch.checkpoint.tracker import TRACKER_HEADER, update_tracker

__all__ = [
    "load_model_checkpoint",
    "load_optim_checkpoint",
    "refuse_msgpack",
    "save_model_checkpoint",
    "save_optim_checkpoint",
    "TRACKER_HEADER",
    "update_tracker",
]
