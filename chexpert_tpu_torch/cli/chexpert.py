"""chexpert CLI of the PyTorch port: train, evaluate, ensemble, visualize,
plot ROC (counterpart of chexpert_tpu/cli/chexpert.py, with its flag names):

    python -m chexpert_tpu_torch.cli.chexpert --train --evaluate_single_model \\
        --data_path DIR --model aadensenet121 [--device cuda]
    python -m chexpert_tpu_torch.cli.chexpert --evaluate_single_model \\
        --restore run/checkpoint_latest.pt --output_dir run ...
    python -m chexpert_tpu_torch.cli.chexpert --evaluate_ensemble \\
        [--ensemble_member_chunk K] --restore run/best_checkpoints --output_dir run ...
    python -m chexpert_tpu_torch.cli.chexpert --visualize \\
        --restore run/checkpoint_latest.pt --output_dir run ...
    python -m chexpert_tpu_torch.cli.chexpert --plot_roc --output_dir run ...

The run directory gets config.json, scalars.jsonl, checkpoint_latest.pt,
optim_checkpoint_latest.pt, checkpoints_tracker.csv,
best_checkpoints/checkpoint_<id>.pt and eval_results_step_N.json; the
ensemble writes eval_results_ensemble.json, the visualization
vis/vis_<category>_step_N.png (and vis/attn_image_idx_*_layer_*.png for a
model with attention), and --plot_roc plots/roc_pr_<eval_results name>.png
for every eval_results*.json in --output_dir (the PNGs need matplotlib).
The run goes on ``--device`` (default ``cuda``; asking for it on a host
without a card raises, the CPU runs only when asked).

The fast input path: ``--packed_cache`` decodes each split once into a uint8
cache under ``<data_path>/CheXpert-v1.0-small/packed`` (with a 32-pixel crop
margin for ``--data_aug`` training) and streams it; ``--device_aug`` then
crops and flips on the device instead of the host. ``--profile`` writes a
``torch.profiler`` trace of steps 3-12 of epoch 0 to
``<output_dir>/profile/trace.json``. ``--pretrained`` starts from
``$CHEXPERT_TPU_PRETRAINED_DIR/<model>.pth`` (the head excepted); a restore
re-reads the flag from the restored run's config.json.

Multi-process training: one process per device, started by a launcher,
with ``--multihost`` and an explicit ``--output_dir``:

    torchrun --nproc_per_node N -m chexpert_tpu_torch.cli.chexpert --train \
        --multihost --output_dir D [--data_parallel DP --model_parallel MP] ...

``--batch_size`` is the global batch; each rank loads its data row's slice
of it, BatchNorm reduces over the global batch, the gradients are averaged
by DistributedDataParallel, eval gathers every rank's rows, and rank 0 alone
writes (chexpert_tpu_torch/parallel). ``--visualize`` runs in one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pprint

import numpy as np
import torch
import torch.distributed as dist

from chexpert_tpu_torch.checkpoint import load_model_checkpoint, load_optim_checkpoint
from chexpert_tpu_torch.configs import Config, resolve_output_dir, setup_output_dir
from chexpert_tpu_torch.data import Batches, ChexpertIndex, denormalize, extract_patient_ids
from chexpert_tpu_torch.eval import evaluate_ensemble, list_checkpoints
from chexpert_tpu_torch.interpret import (
    capture_attention_weights,
    grad_cam,
    plot_roc,
    save_attn_maps,
    save_vis_grids,
)
from chexpert_tpu_torch.data.chexpert import DIR_NAME, PIXEL_MEAN, PIXEL_STD
from chexpert_tpu_torch.data.packed import PackedBatches, build_packed_cache
from chexpert_tpu_torch.models import build_model, normalize_state_dict, optimizer_spec
from chexpert_tpu_torch.models.attn import ATTN_IMPLS
from chexpert_tpu_torch.models.pretrained import load_pretrained
from chexpert_tpu_torch.parallel import (
    convert_global_batchnorm,
    create_hybrid_mesh,
    create_mesh,
    host_batch_slice_from_mesh,
    multihost,
)
from chexpert_tpu_torch.train import (
    TrainState,
    data_parallel,
    make_optimizer,
    prepare_image,
    rank_seed,
)
from chexpert_tpu_torch.train.loop import evaluate_single_model, train_and_evaluate
from chexpert_tpu_torch.utils import MetricsWriter, load_json, resolve_device, save_json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_config", type=str, help="Path to config.json to load args from.")
    p.add_argument("--train", action="store_true", help="Train model.")
    p.add_argument("--evaluate_single_model", action="store_true")
    p.add_argument("--evaluate_ensemble", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--plot_roc", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_path", default="")
    p.add_argument("--output_dir", default="")
    p.add_argument("--restore", type=str, default="")
    p.add_argument("--model", default="densenet121")
    p.add_argument("--mini_data", type=int, default=None)
    p.add_argument("--resize", type=int, default=None)
    p.add_argument("--data_filter", type=str, default="",
                   help='JSON row filter, e.g. \'{"Frontal/Lateral": "Frontal"}\'')
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_decay_factor", type=float, default=0.97)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--eval_interval", type=int, default=300)
    p.add_argument("--uncertain_policy", default="ones", choices=["ones", "zeros", "ignore"])
    p.add_argument("--auto_resume", action="store_true",
                   help="Resume from output_dir/checkpoint_latest.pt if present.")
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--attn_impl", default="pallas", choices=list(ATTN_IMPLS))
    p.add_argument("--data_workers", type=int, default=8)
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--image_size", type=int, default=320)
    p.add_argument("--data_aug", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' on request)")
    p.add_argument("--ensemble_member_chunk", type=int, default=0,
                   help="members per ensemble pass; 0 = planned from the free device "
                        "memory, halved on an out-of-memory error")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data rows of the (data, model) grid of ranks; 0 = all ranks")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model columns of the grid (the ensemble splits its members "
                        "over them)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run: join the launcher's process group "
                        "(torchrun's RANK / WORLD_SIZE / MASTER_ADDR ...)")
    p.add_argument("--profile", action="store_true",
                   help="Capture a torch.profiler trace of the first train steps.")
    p.add_argument("--packed_cache", action="store_true",
                   help="Decode-once uint8 cache for the input pipeline.")
    p.add_argument("--device_aug", action="store_true",
                   help="With --packed_cache --data_aug: crop and flip on the device "
                        "(default: on the host).")
    return p


def config_from_args(argv=None) -> Config:
    raw = vars(build_parser().parse_args(argv))
    load_config = raw.pop("load_config", None)
    cfg = Config.from_dict(raw)
    if load_config:  # config overlay (reference chexpert.py:437)
        overlay = load_json(load_config)
        cfg = cfg.replace(**{k: v for k, v in overlay.items()
                             if k in Config.__dataclass_fields__})
    return cfg


class Runner:
    """Holds the live objects: mesh, device, model, optimizer, state, pipelines."""

    def __init__(self, cfg: Config):
        device = resolve_device(cfg.device)
        if cfg.multihost:
            multihost.initialize(device)
            # each rank loads its data row's contiguous slice of the global
            # batch, derived from (and checked against) the grid of ranks
            self.mesh = create_hybrid_mesh(cfg.data_parallel, cfg.model_parallel).connect()
            self.host_slice = host_batch_slice_from_mesh(self.mesh, cfg.batch_size)
        else:
            self.mesh = create_mesh(cfg.data_parallel, cfg.model_parallel)
            self.host_slice = None
        n_data = self.mesh.data_parallel
        if cfg.batch_size % n_data:
            raise AssertionError(
                f"batch_size {cfg.batch_size} must divide over data axis {n_data}")
        self.device = multihost.local_device(device)
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        model = build_model(cfg.model, image_size=cfg.resize or cfg.image_size,
                            attn_impl=cfg.attn_impl,
                            generator=torch.Generator().manual_seed(cfg.seed))
        # --lr_decay_factor overrides the arch spec's exponential gamma
        spec = dataclasses.replace(optimizer_spec(cfg.model), decay_factor=cfg.lr_decay_factor)
        if cfg.auto_resume and not cfg.restore:
            latest = os.path.join(cfg.output_dir, "checkpoint_latest.pt")
            if os.path.exists(latest):
                cfg = cfg.replace(restore=latest)
        self.cfg = cfg
        # the pretrained weights matter only for a fresh start: a pending
        # restore would overwrite them, and a pretrained run restores without
        # the weight file
        if cfg.pretrained and not cfg.restore:
            load_pretrained(model, cfg.model)
        hw = cfg.resize or cfg.image_size
        # --device_aug: the crop and flip run in the train step on the stored
        # tiles (train/steps.py::device_augment)
        self.device_crop = hw if (cfg.data_aug and cfg.packed_cache and cfg.device_aug) else None
        self.start_step = 0
        # a --restore that is not a file (a directory is --evaluate_ensemble's,
        # which reads it itself, or nothing is there yet) is skipped, as the
        # JAX Runner skips it
        restore = bool(cfg.restore) and os.path.isfile(cfg.restore)
        if cfg.restore and not restore:
            print(f"Not restoring: --restore {cfg.restore!r} is not a checkpoint file")
        if restore:
            print(f"Restoring model weights from {cfg.restore}")
            ck = load_model_checkpoint(cfg.restore)
            model.load_state_dict(normalize_state_dict(ck["state_dict"], cfg.model), strict=True)
            self.start_step = ck["global_step"]
        model = model.to(self.device)
        if n_data > 1:  # before the optimizer: the converted model keeps its parameters
            convert_global_batchnorm(model, self.mesh.data_group)
        optimizer, scheduler, self.schedule = make_optimizer(
            spec, model.parameters(), cfg.lr, cfg.lr_warmup_steps)
        # the train-mode random parts draw from this, on the model's device
        row = self.mesh.data_index
        generator = torch.Generator(device=self.device).manual_seed(rank_seed(cfg.seed, row))
        ddp = data_parallel(model, self.device) if cfg.train and self.mesh.world > 1 else None
        self.state = TrainState(model, optimizer, scheduler, step=self.start_step,
                                generator=generator, ddp=ddp)
        if restore and cfg.train:
            optim_path = os.path.join(os.path.dirname(cfg.restore),
                                      "optim_" + os.path.basename(cfg.restore))
            if os.path.exists(optim_path):
                print("Restoring optimizer.")
                load_optim_checkpoint(optim_path, optimizer, scheduler, generator)
                if row:  # the checkpoint holds data row 0's generator
                    generator.manual_seed(rank_seed(cfg.seed, row, self.start_step))

    def index(self, mode: str) -> ChexpertIndex:
        cfg = self.cfg
        return ChexpertIndex(cfg.data_path, mode,
                             data_filter=json.loads(cfg.data_filter) if cfg.data_filter else None,
                             mini_data=cfg.mini_data, uncertain_policy=cfg.uncertain_policy)

    def batches(self, index: ChexpertIndex, train: bool, epoch: int = 0):
        """Batches of ``index``: from the packed cache under --packed_cache
        (built here on first use; test mode keeps the JPEG pipeline), else
        decoded from the JPEGs."""
        cfg = self.cfg
        # drop_last in train: a zero-padded partial batch would pollute the
        # BatchNorm batch statistics
        drop_last = train and len(index) >= cfg.batch_size
        if cfg.packed_cache and index.mode != "test":
            hw = cfg.resize or cfg.image_size
            path = build_packed_cache(
                index, os.path.join(cfg.data_path, DIR_NAME, "packed"), image_size=hw,
                resize=cfg.resize, workers=cfg.data_workers,
                pack_margin=32 if (train and cfg.data_aug) else 0)
            device_aug = train and cfg.data_aug and cfg.device_aug
            return PackedBatches(index, path, cfg.batch_size, image_size=hw, shuffle=train,
                                 augment=train and cfg.data_aug and not device_aug,
                                 emit_stored=device_aug, drop_last=drop_last, seed=cfg.seed,
                                 epoch=epoch, host_slice=self.host_slice)
        return Batches(index, cfg.batch_size, shuffle=train, augment=train and cfg.data_aug,
                       image_size=cfg.image_size, resize=cfg.resize, workers=cfg.data_workers,
                       seed=cfg.seed, epoch=epoch, drop_last=drop_last,
                       host_slice=self.host_slice)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.state.model.parameters())


def reread_pretrained_flag(cfg: Config) -> Config:
    """The ``pretrained`` flag re-read on restore from the config.json saved
    beside the restore target (its run directory, stepping out of
    best_checkpoints/), else from ``output_dir``'s (JAX
    cli/chexpert.py::reread_pretrained_flag; reference chexpert.py:521-524)."""
    if not cfg.restore:
        return cfg
    run_dir = cfg.restore if os.path.isdir(cfg.restore) else os.path.dirname(cfg.restore)
    if os.path.basename(os.path.normpath(run_dir)) == "best_checkpoints":
        run_dir = os.path.dirname(os.path.normpath(run_dir))
    for saved_cfg in (os.path.join(run_dir, "config.json"),
                      os.path.join(cfg.output_dir, "config.json")):
        if os.path.exists(saved_cfg):
            return cfg.replace(
                pretrained=load_json(saved_cfg).get("pretrained", cfg.pretrained))
    return cfg


def collect_visualization(runner: Runner) -> dict:
    """The device work of --visualize (reference chexpert.py:305-397): over
    the vis subset, Grad-CAM and the sigmoid probabilities of the model, and
    its attention weights captured on the einsum route, chunked over each
    batch. Returns host arrays: images (N, H, W, 1) denormalized, labels,
    probs (N, 5), cams (N, 1, H, W), indices, patient_ids, attn_weights (one
    (N, nh, HW, HW) array per AA layer, in the JAX package's order; [] for a
    model with no attention), vis_attrs and vis_idxs."""
    vis_index = runner.index("vis")
    model = runner.state.model
    imgs, labels, probs, cams, idx_list = [], [], [], [], []
    attn_per_layer = None
    for batch in runner.batches(vis_index, train=False):
        if batch["image"].dtype == np.uint8:  # the packed cache's raw tiles: whiten here
            batch = dict(batch, image=(batch["image"].astype(np.float32) / 255.0 - PIXEL_MEAN)
                         / PIXEL_STD)
        x = prepare_image(torch.from_numpy(batch["image"]).to(runner.device))
        cam, logits = grad_cam(model, x, compute_dtype=runner.compute_dtype)
        m = batch["mask"].astype(bool)
        imgs.append(denormalize(batch["image"][m]))
        labels.append(batch["label"][m])
        probs.append(torch.sigmoid(logits).cpu().numpy()[m])
        cams.append(cam.cpu().numpy()[m])
        idx_list += batch["index"][m].tolist()
        weights = capture_attention_weights(model, x, compute_dtype=runner.compute_dtype)
        if weights:
            w = [wi[m] for wi in weights]
            attn_per_layer = (w if attn_per_layer is None else
                              [np.concatenate([a, b]) for a, b in zip(attn_per_layer, w)])
    return {"images": np.concatenate(imgs), "labels": np.concatenate(labels),
            "probs": np.concatenate(probs), "cams": np.concatenate(cams),
            "indices": idx_list, "patient_ids": extract_patient_ids(vis_index, idx_list),
            "attn_weights": attn_per_layer or [], "vis_attrs": vis_index.vis_attrs,
            "vis_idxs": vis_index.vis_idxs}


def render_visualization(vis: dict, output_dir: str, step: int) -> None:
    """The PNGs of --visualize from ``collect_visualization``'s arrays: the
    Grad-CAM grid of each vis category and, for a model with attention, the
    attention maps of every image and layer."""
    save_vis_grids(vis["images"], vis["cams"], vis["labels"], vis["probs"], vis["indices"],
                   vis["patient_ids"], vis["vis_attrs"], vis["vis_idxs"], output_dir, step)
    if vis["attn_weights"]:
        for b in range(len(vis["images"])):
            save_attn_maps(vis["images"], vis["attn_weights"], vis["patient_ids"],
                           vis["indices"], output_dir, b)


def plot_eval_results(output_dir: str) -> None:
    """--plot_roc: a ROC/PR figure for every eval_results*.json in output_dir."""
    filenames = [f for f in sorted(os.listdir(output_dir))
                 if f.startswith("eval_results") and f.endswith(".json")]
    if not filenames:
        raise RuntimeError(
            f"No `eval_results` files found in `{output_dir}` to plot results from.")
    for f in filenames:
        plot_roc(load_json(os.path.join(output_dir, f)), output_dir,
                 "roc_pr_" + f.split(".")[0])


def main(argv=None) -> int:
    cfg = config_from_args(argv)
    device = resolve_device(cfg.device)
    # the process group comes up before any artifact is written: the rank
    # gates the writes, and a timestamped default output_dir would differ
    # between the ranks
    created = cfg.multihost and multihost.initialize(device)
    try:
        if multihost.world_size() > 1:
            if not cfg.output_dir:
                raise AssertionError("--multihost requires an explicit --output_dir")
            if cfg.visualize:
                # per-rank batch slices would hand each process part of a
                # category, and the ranks would race on the PNGs
                raise AssertionError("--visualize is a single-process tool: run it without "
                                     "--multihost on one host, restoring the checkpoint")
        return _run(cfg)
    finally:
        if created:
            dist.destroy_process_group()


def _run(cfg: Config) -> int:
    cfg = resolve_output_dir(cfg)
    setup_output_dir(cfg)
    writer = MetricsWriter(cfg.output_dir)
    try:
        writer.add_text("config", str(cfg.to_dict()))
        runner = Runner(reread_pretrained_flag(cfg))
        cfg = runner.cfg
        mesh = runner.mesh
        print(f"Loaded {cfg.model} (number of parameters: {runner.n_params():,}; "
              f"weights trained to step {runner.start_step}) on {runner.device}; "
              f"mesh {mesh.shape}, rank {mesh.rank}")
        valid_index = runner.index("valid")
        valid_batches = runner.batches(valid_index, train=False)
        if cfg.train:
            train_index = runner.index("train")
            print("Train data length:", len(train_index))
            print("Valid data length:", len(valid_index))
            train_and_evaluate(cfg, runner.state,
                               lambda epoch: runner.batches(train_index, True, epoch),
                               valid_batches, runner.schedule, writer, runner.device,
                               runner.compute_dtype, mesh=mesh,
                               device_crop=runner.device_crop)
        if cfg.evaluate_single_model:
            metrics = evaluate_single_model(runner.state, valid_batches, runner.device,
                                            runner.compute_dtype, mesh)
            step = runner.state.step
            print(f"Evaluate metrics -- \n\t restore: {cfg.restore} \n\t step: {step}:")
            print("AUC:\n", pprint.pformat(metrics["aucs"]))
            print("Loss:\n", pprint.pformat(metrics["loss"]))
            save_json(metrics, f"eval_results_step_{step}", cfg.output_dir)
        if cfg.evaluate_ensemble:
            if not os.path.isdir(cfg.restore):
                raise AssertionError("Restore argument must be directory with saved checkpoints")
            paths = list_checkpoints(cfg.restore)
            print(f"Running ensemble prediction using {len(paths)} checkpoints.")
            metrics = evaluate_ensemble(runner.state.model, paths, valid_batches, runner.device,
                                        runner.compute_dtype, cfg.model,
                                        member_chunk=cfg.ensemble_member_chunk, mesh=mesh)
            print("AUC:\n", pprint.pformat(metrics["aucs"]))
            print("Loss:\n", pprint.pformat(metrics["loss"]))
            save_json(metrics, "eval_results_ensemble", cfg.output_dir)
        if cfg.visualize:
            render_visualization(collect_visualization(runner), cfg.output_dir,
                                 runner.state.step)
        if cfg.plot_roc and multihost.is_primary():
            plot_eval_results(cfg.output_dir)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
