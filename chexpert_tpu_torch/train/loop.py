"""Train / evaluate loops (port of chexpert_tpu/train/loop.py): per-step
BCE loss, scalars every ``log_interval`` steps, inline eval + best-K
checkpointing every ``eval_interval`` steps, and an eval after each epoch
written to eval_results_step_N.json (reference chexpert.py:152-255). Eval
batches are zero-padded and masked, so padded rows never reach the metrics.

In a multi-process run (``mesh`` over more than one rank) each rank steps
on its slice of every global batch; the logged loss is the global batch's
(the mean over the data rows), images per second count global images, eval
gathers every rank's rows before the metrics, so every rank computes the
same ones, and only the primary process writes.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

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
from chexpert_tpu_torch.parallel.mesh import Mesh, create_mesh
from chexpert_tpu_torch.parallel.multihost import is_primary
from chexpert_tpu_torch.train.state import TrainState
from chexpert_tpu_torch.train.steps import eval_step, train_step
from chexpert_tpu_torch.utils import MetricsWriter, save_json


def evaluate(state: TrainState, batches: Batches, device: torch.device,
             compute_dtype: torch.dtype, mesh: Optional[Mesh] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full pass collecting (outputs, targets, per-element losses) of the
    valid rows (reference evaluate, chexpert.py:198-211). Over several data
    rows the rank's unmasked rows are all-gathered in global batch order
    (equal shapes on every rank) and the padding mask is applied after, as
    the JAX loop does."""
    outs, targets, losses, masks = [], [], [], []
    for batch in device_prefetch(batches, device):
        out, per_elem = eval_step(state, batch, compute_dtype)
        outs.append(out.cpu().numpy())
        targets.append(batch["label"].cpu().numpy())
        losses.append(per_elem.cpu().numpy())
        masks.append(batch["mask"].cpu().numpy())
    rows = (np.concatenate(outs), np.concatenate(targets), np.concatenate(losses),
            np.concatenate(masks))
    if mesh is not None:
        rows = mesh.gather_batches(rows, len(masks[0]))
    keep = rows[3].astype(bool)
    return rows[0][keep], rows[1][keep], rows[2][keep]


def evaluate_single_model(state: TrainState, batches: Batches, device: torch.device,
                          compute_dtype: torch.dtype, mesh: Optional[Mesh] = None) -> Dict:
    return compute_metrics(*evaluate(state, batches, device, compute_dtype, mesh))


def _log_eval(writer: MetricsWriter, metrics: Dict, step: int) -> None:
    writer.add_scalar("eval_loss", sum_loss(metrics), step)
    for k, v in metrics["aucs"].items():
        writer.add_scalar(f"eval_auc_class_{k}", v, step)


def _checkpoint(cfg: Config, state: TrainState, metrics: Dict, step: int) -> None:
    """latest + optimizer + tracked best-K (reference save_checkpoint,
    chexpert.py:90-123), written by the primary process alone: the model is
    the same on every rank and the metrics are gathered ones."""
    if not is_primary():
        return
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


def _start_profile(cfg: Config, device: torch.device, log_fn):
    from torch.profiler import ProfilerActivity, profile

    log_fn(f"Capturing profiler trace to {os.path.join(cfg.output_dir, 'profile')}")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(cfg: Config, prof) -> None:
    """Stop the trace; the primary process writes it as a Chrome trace to
    ``<output_dir>/profile/trace.json``."""
    prof.stop()
    if is_primary():
        trace_dir = os.path.join(cfg.output_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def train_epoch(cfg: Config, state: TrainState, train_batches: Batches,
                valid_batches: Batches, schedule: Callable, writer: MetricsWriter,
                device: torch.device, compute_dtype: torch.dtype, epoch: int,
                log_fn=print, mesh: Optional[Mesh] = None,
                device_crop: Optional[int] = None) -> TrainState:
    """(reference train_epoch, chexpert.py:152-196). Under ``cfg.profile``
    steps 3-12 of epoch 0 (0-based) run under ``torch.profiler``, stopped at
    the epoch's end when it is shorter (train/loop.py:132-168 of the JAX
    package)."""
    mesh = mesh or create_mesh()
    t0, imgs = time.time(), 0
    prof_start, prof_stop = (3, 13) if (cfg.profile and epoch == 0) else (-1, -1)
    prof, local = None, 0
    for batch in device_prefetch(train_batches, device, depth=cfg.prefetch):
        if local == prof_start:
            prof = _start_profile(cfg, device, log_fn)
        loss = train_step(state, batch, compute_dtype, device_crop)
        local += 1
        if local == prof_stop:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            _stop_profile(cfg, prof)
            prof = None
        step = state.step
        # train drops partial batches, so every batch is full
        imgs += int(batch["mask"].shape[0]) * mesh.data_parallel
        if cfg.log_interval and step % cfg.log_interval == 0:
            loss_val = mesh.mean_over_data(float(loss))  # waits for the step to finish
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
            metrics = evaluate_single_model(state, valid_batches, device, compute_dtype, mesh)
            _log_eval(writer, metrics, step)
            _checkpoint(cfg, state, metrics, step)
            t0, imgs = time.time(), 0
    if prof is not None:  # the epoch ended inside the trace window
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _stop_profile(cfg, prof)
    return state


def train_and_evaluate(cfg: Config, state: TrainState, make_train_batches: Callable,
                       valid_batches: Batches, schedule: Callable, writer: MetricsWriter,
                       device: torch.device, compute_dtype: torch.dtype,
                       log_fn=print, mesh: Optional[Mesh] = None,
                       device_crop: Optional[int] = None) -> TrainState:
    """(reference train_and_evaluate, chexpert.py:238-255); make_train_batches
    (epoch) -> Batches or PackedBatches, so shuffling reseeds per epoch;
    ``device_crop``: the train step's on-device crop size (--device_aug)."""
    for epoch in range(cfg.n_epochs):
        state = train_epoch(cfg, state, make_train_batches(epoch), valid_batches, schedule,
                            writer, device, compute_dtype, epoch, log_fn, mesh, device_crop)
        metrics = evaluate_single_model(state, valid_batches, device, compute_dtype, mesh)
        log_fn(f"Evaluate metrics @ step {state.step}:")
        log_fn("AUC: " + str(metrics["aucs"]))
        log_fn("Loss: " + str(metrics["loss"]))
        _log_eval(writer, metrics, state.step)
        save_json(metrics, f"eval_results_step_{state.step}", cfg.output_dir)
    return state
