from chexpert_tpu_torch.train.loss import bce_with_logits, train_loss
from chexpert_tpu_torch.train.optim import make_optimizer, make_schedule
from chexpert_tpu_torch.train.state import TrainState
from chexpert_tpu_torch.train.steps import (
    autocast,
    crop_and_flip,
    data_parallel,
    device_augment,
    eval_logits,
    eval_step,
    prepare_image,
    rank_seed,
    train_step,
)

__all__ = [
    "bce_with_logits",
    "train_loss",
    "make_optimizer",
    "make_schedule",
    "TrainState",
    "autocast",
    "crop_and_flip",
    "data_parallel",
    "device_augment",
    "eval_logits",
    "eval_step",
    "prepare_image",
    "rank_seed",
    "train_step",
]
