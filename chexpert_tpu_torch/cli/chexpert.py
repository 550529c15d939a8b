"""chexpert CLI of the PyTorch port: train and evaluate (counterpart of
chexpert_tpu/cli/chexpert.py, with its flag names):

    python -m chexpert_tpu_torch.cli.chexpert --train --evaluate_single_model \\
        --data_path DIR --model aadensenet121 [--device cuda]
    python -m chexpert_tpu_torch.cli.chexpert --evaluate_single_model \\
        --restore run/checkpoint_latest.pt --output_dir run ...

The run directory gets config.json, scalars.jsonl, checkpoint_latest.pt,
optim_checkpoint_latest.pt, checkpoints_tracker.csv,
best_checkpoints/checkpoint_<id>.pt and eval_results_step_N.json. The run
goes on ``--device`` (default ``cuda``; asking for it on a host without a
card raises, the CPU runs only when asked). ``--evaluate_ensemble``
(ROADMAP.md slice 3), ``--visualize`` and ``--plot_roc`` (slice 6) raise
NotImplementedError, as do the JAX package's TPU-only flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pprint

import torch

from chexpert_tpu_torch.checkpoint import load_model_checkpoint, load_optim_checkpoint
from chexpert_tpu_torch.configs import Config, resolve_output_dir, setup_output_dir
from chexpert_tpu_torch.data import Batches, ChexpertIndex
from chexpert_tpu_torch.models import build_model, normalize_state_dict, optimizer_spec
from chexpert_tpu_torch.models.attn import ATTN_IMPLS
from chexpert_tpu_torch.train import TrainState, make_optimizer
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
    # the JAX package's flags the port does not run yet: accepted, and refused
    # by Config.check_supported
    p.add_argument("--ensemble_member_chunk", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--packed_cache", action="store_true")
    p.add_argument("--device_aug", action="store_true")
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


def check_actions(cfg: Config) -> None:
    if cfg.evaluate_ensemble:
        raise NotImplementedError("--evaluate_ensemble is not ported to PyTorch yet "
                                  "(ROADMAP.md slice 3)")
    if cfg.visualize or cfg.plot_roc:
        raise NotImplementedError("--visualize / --plot_roc are not ported to PyTorch yet "
                                  "(ROADMAP.md slice 6)")
    cfg.check_supported()


class Runner:
    """Holds the live objects: device, model, optimizer, state, pipelines."""

    def __init__(self, cfg: Config):
        self.device = resolve_device(cfg.device)
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
        if cfg.pretrained and not cfg.restore:
            raise NotImplementedError("--pretrained (ImageNet weights) is not ported to "
                                      "PyTorch yet (ROADMAP.md slice 8)")
        self.start_step = 0
        if cfg.restore:
            if not os.path.isfile(cfg.restore):
                raise FileNotFoundError(f"--restore {cfg.restore!r} is not a checkpoint file")
            print(f"Restoring model weights from {cfg.restore}")
            ck = load_model_checkpoint(cfg.restore)
            model.load_state_dict(normalize_state_dict(ck["state_dict"], cfg.model), strict=True)
            self.start_step = ck["global_step"]
        model = model.to(self.device)
        optimizer, scheduler, self.schedule = make_optimizer(
            spec, model.parameters(), cfg.lr, cfg.lr_warmup_steps)
        # the train-mode random parts draw from this, on the model's device
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.state = TrainState(model, optimizer, scheduler, step=self.start_step,
                                generator=generator)
        if cfg.restore and cfg.train:
            optim_path = os.path.join(os.path.dirname(cfg.restore),
                                      "optim_" + os.path.basename(cfg.restore))
            if os.path.exists(optim_path):
                print("Restoring optimizer.")
                load_optim_checkpoint(optim_path, optimizer, scheduler, generator)

    def index(self, mode: str) -> ChexpertIndex:
        cfg = self.cfg
        return ChexpertIndex(cfg.data_path, mode,
                             data_filter=json.loads(cfg.data_filter) if cfg.data_filter else None,
                             mini_data=cfg.mini_data, uncertain_policy=cfg.uncertain_policy)

    def batches(self, index: ChexpertIndex, train: bool, epoch: int = 0) -> Batches:
        cfg = self.cfg
        return Batches(index, cfg.batch_size, shuffle=train, augment=train and cfg.data_aug,
                       image_size=cfg.image_size, resize=cfg.resize, workers=cfg.data_workers,
                       seed=cfg.seed, epoch=epoch,
                       drop_last=train and len(index) >= cfg.batch_size)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.state.model.parameters())


def main(argv=None) -> int:
    cfg = config_from_args(argv)
    check_actions(cfg)
    resolve_device(cfg.device)  # before any artifact is written
    cfg = resolve_output_dir(cfg)
    setup_output_dir(cfg)
    writer = MetricsWriter(cfg.output_dir)
    try:
        writer.add_text("config", str(cfg.to_dict()))
        runner = Runner(cfg)
        cfg = runner.cfg
        print(f"Loaded {cfg.model} (number of parameters: {runner.n_params():,}; "
              f"weights trained to step {runner.start_step}) on {runner.device}")
        valid_index = runner.index("valid")
        valid_batches = runner.batches(valid_index, train=False)
        if cfg.train:
            train_index = runner.index("train")
            print("Train data length:", len(train_index))
            print("Valid data length:", len(valid_index))
            train_and_evaluate(cfg, runner.state,
                               lambda epoch: runner.batches(train_index, True, epoch),
                               valid_batches, runner.schedule, writer, runner.device,
                               runner.compute_dtype)
        if cfg.evaluate_single_model:
            metrics = evaluate_single_model(runner.state, valid_batches, runner.device,
                                            runner.compute_dtype)
            step = runner.state.step
            print(f"Evaluate metrics -- \n\t restore: {cfg.restore} \n\t step: {step}:")
            print("AUC:\n", pprint.pformat(metrics["aucs"]))
            print("Loss:\n", pprint.pformat(metrics["loss"]))
            save_json(metrics, f"eval_results_step_{step}", cfg.output_dir)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
