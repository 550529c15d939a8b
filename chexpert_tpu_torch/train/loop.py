"""Train / evaluate loops (port of chexpert_tpu/train/loop.py, one
process): per-step BCE loss, scalars every ``log_interval`` steps, inline
eval + best-K checkpointing every ``eval_interval`` steps, and an eval
after each epoch written to eval_results_step_N.json (reference
chexpert.py:152-255). Eval batches are zero-padded and masked, so padded
rows never reach the metrics.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from chexpert_tpu_torch.checkpoint import (
    save_model_checkpoint,
    save_optim_checkpoint,
    update_tracker,
)
from chexpert_tpu_torch.configs import Config
from chexpert_tpu_torch.data.pipeline import Batches, device_prefetch
from chexpert_tpu_torch.eval.metrics import avg_auc, compute_metrics, sum_loss
from chexpert_tpu_torch.train.state import TrainState
from chexpert_tpu_torch.train.steps import eval_step, train_step
from chexpert_tpu_torch.utils import MetricsWriter, save_json


def evaluate(state: TrainState, batches: Batches, device: torch.device,
             compute_dtype: torch.dtype) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full pass collecting (outputs, targets, per-element losses) of the
    valid rows (reference evaluate, chexpert.py:198-211)."""
    outs, targets, losses, masks = [], [], [], []
    for batch in device_prefetch(batches, device):
        out, per_elem = eval_step(state, batch, compute_dtype)
        outs.append(out.cpu().numpy())
        targets.append(batch["label"].cpu().numpy())
        losses.append(per_elem.cpu().numpy())
        masks.append(batch["mask"].cpu().numpy())
    keep = np.concatenate(masks).astype(bool)
    return (np.concatenate(outs)[keep], np.concatenate(targets)[keep],
            np.concatenate(losses)[keep])


def evaluate_single_model(state: TrainState, batches: Batches, device: torch.device,
                          compute_dtype: torch.dtype) -> Dict:
    return compute_metrics(*evaluate(state, batches, device, compute_dtype))


def _log_eval(writer: MetricsWriter, metrics: Dict, step: int) -> None:
    writer.add_scalar("eval_loss", sum_loss(metrics), step)
    for k, v in metrics["aucs"].items():
        writer.add_scalar(f"eval_auc_class_{k}", v, step)


def _checkpoint(cfg: Config, state: TrainState, metrics: Dict, step: int) -> None:
    """latest + optimizer + tracked best-K (reference save_checkpoint,
    chexpert.py:90-123)."""
    eval_loss = sum_loss(metrics)
    auc_mean = avg_auc(metrics)
    sd = state.model.state_dict()
    save_model_checkpoint(os.path.join(cfg.output_dir, "checkpoint_latest.pt"), sd, step,
                          eval_loss, auc_mean)
    save_optim_checkpoint(os.path.join(cfg.output_dir, "optim_checkpoint_latest.pt"),
                          state.optimizer, state.scheduler, state.generator)
    update_tracker(
        cfg.output_dir, step, eval_loss, auc_mean,
        save_best=lambda p: save_model_checkpoint(p, sd, step, eval_loss, auc_mean),
        max_records=cfg.max_best_checkpoints,
    )


def train_epoch(cfg: Config, state: TrainState, train_batches: Batches,
                valid_batches: Batches, schedule: Callable, writer: MetricsWriter,
                device: torch.device, compute_dtype: torch.dtype, epoch: int,
                log_fn=print) -> TrainState:
    """(reference train_epoch, chexpert.py:152-196)"""
    t0, imgs = time.time(), 0
    for batch in device_prefetch(train_batches, device, depth=cfg.prefetch):
        loss = train_step(state, batch, compute_dtype)
        step = state.step
        # train drops partial batches, so every batch is full
        imgs += int(batch["mask"].shape[0])
        if cfg.log_interval and step % cfg.log_interval == 0:
            loss_val = float(loss)  # waits for the step to finish
            lr = schedule(step - 1)
            dt = time.time() - t0
            ips = imgs / dt if dt > 0 else 0.0
            writer.add_scalar("train_loss", loss_val, step)
            writer.add_scalar("lr", lr, step)
            writer.add_scalar("images_per_sec", ips, step)
            log_fn(f"epoch {epoch + 1}/{cfg.n_epochs} step {step} "
                   f"loss {loss_val:.4f} lr {lr:.3e} {ips:.1f} img/s")
            t0, imgs = time.time(), 0
        if cfg.eval_interval and step % cfg.eval_interval == 0:
            metrics = evaluate_single_model(state, valid_batches, device, compute_dtype)
            _log_eval(writer, metrics, step)
            _checkpoint(cfg, state, metrics, step)
            t0, imgs = time.time(), 0
    return state


def train_and_evaluate(cfg: Config, state: TrainState, make_train_batches: Callable,
                       valid_batches: Batches, schedule: Callable, writer: MetricsWriter,
                       device: torch.device, compute_dtype: torch.dtype,
                       log_fn=print) -> TrainState:
    """(reference train_and_evaluate, chexpert.py:238-255); make_train_batches
    (epoch) -> Batches, so shuffling reseeds per epoch."""
    for epoch in range(cfg.n_epochs):
        state = train_epoch(cfg, state, make_train_batches(epoch), valid_batches, schedule,
                            writer, device, compute_dtype, epoch, log_fn)
        metrics = evaluate_single_model(state, valid_batches, device, compute_dtype)
        log_fn(f"Evaluate metrics @ step {state.step}:")
        log_fn("AUC: " + str(metrics["aucs"]))
        log_fn("Loss: " + str(metrics["loss"]))
        _log_eval(writer, metrics, state.step)
        save_json(metrics, f"eval_results_step_{state.step}", cfg.output_dir)
    return state
