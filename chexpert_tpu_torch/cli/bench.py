"""CIFAR model test-bench CLI of the PyTorch port (counterpart of
chexpert_tpu/cli/bench.py, with its subcommands, flags and defaults):
per-arch subcommands (efficientnet / resnet / wideresnet / densenet),
attention flags, CIFAR-10/100 with the standard augmentation (reflect-pad 4,
random flip, random crop 32), cross-entropy training with the per-arch
optimizer and warmup schedule, top-1 / top-5 accuracy, a one-batch
``--mini_data`` overfit mode, checkpoint save / restore and attention-map
visualization.

    python -m chexpert_tpu_torch.cli.bench wideresnet 28 10 --attn --train --evaluate \\
        --vis_attn --synthetic [--device cuda]
    python -m chexpert_tpu_torch.cli.bench efficientnet b0 --train --synthetic

Data: the standard CIFAR python pickles (cifar-10-batches-py /
cifar-100-python) under ``--data_dir``, or ``--synthetic``: a labelled random
set of the same shapes, drawn from ``--seed``. The run goes on ``--device``
(default ``cuda``; asking for it without a card raises), bf16 autocast with
f32 parameters unless ``--compute_dtype float32``. The attention layout is
``CHEXPERT_ATTN_LAYOUT`` (``bn`` or ``hil``), read once when the model is
built. One process drives one device: ``--data_parallel`` above 1 raises
the JAX ``create_mesh`` assertion. The run directory gets config.json,
scalars.jsonl (train_loss, lr, eval_loss, acc@top1, acc@top5),
checkpoint.pt and optim_checkpoint.pt at each evaluation, and with
``--vis_attn`` vis/attn_image_idx_*_layer_*.png (matplotlib).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chexpert_tpu_torch.checkpoint import (
    load_model_checkpoint,
    load_optim_checkpoint,
    save_model_checkpoint,
    save_optim_checkpoint,
)
from chexpert_tpu_torch.models import AttnParams, DenseNet, EfficientNet, ResNet, WideResNet
from chexpert_tpu_torch.models.attn import ATTN_IMPLS
from chexpert_tpu_torch.models.registry import OptimizerSpec, attn_layout_from_env
from chexpert_tpu_torch.parallel import create_mesh
from chexpert_tpu_torch.train import autocast, eval_logits, make_optimizer
from chexpert_tpu_torch.utils import MetricsWriter, resolve_device, save_json

# reference normalization constants (test_model.py:268)
CIFAR_MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
CIFAR_STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0

RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--attn", action="store_true")
    common.add_argument("--attn_k", type=float, default=0.2)
    common.add_argument("--attn_v", type=float, default=0.1)
    common.add_argument("--attn_nh", type=int, default=8)
    common.add_argument("--attn_relative", type=lambda s: s.lower() != "false", default=True)
    common.add_argument("--input_dims", default=(32, 32), type=int, nargs="+")
    common.add_argument("--attn_impl", default="pallas", choices=list(ATTN_IMPLS))
    common.add_argument("--train", action="store_true")
    common.add_argument("--evaluate", action="store_true")
    common.add_argument("--vis_attn", action="store_true")
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--mini_data", action="store_true",
                        help="Truncate dataset to a single batch (overfit check).")
    common.add_argument("--synthetic", action="store_true",
                        help="Generate a synthetic dataset (no CIFAR download possible).")
    common.add_argument("--dataset", default="cifar100", choices=["cifar10", "cifar100"])
    common.add_argument("--data_dir", default="~/data/cifar100/")
    common.add_argument("--output_dir", default="")
    common.add_argument("--restore", type=str, default="")
    common.add_argument("--batch_size", type=int, default=256)
    common.add_argument("--n_epochs", type=int, default=1)
    common.add_argument("--log_interval", type=int, default=1)
    common.add_argument("--eval_interval", type=int, default=10)
    common.add_argument("--weight_decay", type=float, default=1e-5)
    common.add_argument("--lr", type=float, default=0.016)
    common.add_argument("--lr_warmup_epochs", type=int, default=5)
    common.add_argument("--lr_cos_max_epochs", type=int, default=25)
    common.add_argument("--lr_decay_factor", type=float, default=0.97)
    common.add_argument("--lr_decay_epochs", type=float, default=2.4)
    common.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    common.add_argument("--data_parallel", type=int, default=0)
    common.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; 'cpu' on request)")

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="model", required=True)
    pa = sub.add_parser("efficientnet", parents=[common])
    pa.add_argument("architecture", default="b0", choices=[f"b{i}" for i in range(8)])
    pb = sub.add_parser("resnet", parents=[common])
    pb.add_argument("architecture", type=int, default=50, choices=[50, 101, 152])
    pc = sub.add_parser("wideresnet", parents=[common])
    pc.add_argument("architecture", type=int, default=[28, 10], nargs=2)
    pd = sub.add_parser("densenet", parents=[common])
    pd.add_argument("architecture", type=int, default=[12, 100], nargs=2)
    return p


def load_cifar(data_dir: str, dataset: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Standard CIFAR python pickle layout -> (x_train, y_train, x_test,
    y_test), images uint8 NHWC."""
    d = os.path.expanduser(data_dir)

    def unpickle(f):
        with open(f, "rb") as fh:
            return pickle.load(fh, encoding="bytes")

    if dataset == "cifar10":
        base = os.path.join(d, "cifar-10-batches-py")
        xs, ys = [], []
        for i in range(1, 6):
            b = unpickle(os.path.join(base, f"data_batch_{i}"))
            xs.append(b[b"data"])
            ys += list(b[b"labels"])
        xtr, ytr = np.concatenate(xs), np.array(ys)
        t = unpickle(os.path.join(base, "test_batch"))
        xte, yte = t[b"data"], np.array(t[b"labels"])
    else:
        base = os.path.join(d, "cifar-100-python")
        t = unpickle(os.path.join(base, "train"))
        xtr, ytr = t[b"data"], np.array(t[b"fine_labels"])
        t = unpickle(os.path.join(base, "test"))
        xte, yte = t[b"data"], np.array(t[b"fine_labels"])

    def to_nhwc(x):
        return x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    return to_nhwc(xtr), ytr, to_nhwc(xte), yte


def synthetic_cifar(n_classes: int, n_train=512, n_test=256, seed=0):
    """Labelled random data with a planted class signal (a row of 255s at the
    class index mod 32), the same draws as the JAX package's."""
    rng = np.random.RandomState(seed)

    def gen(n):
        y = rng.randint(0, n_classes, n)
        x = rng.randint(0, 255, (n, 32, 32, 3)).astype(np.uint8)
        x[np.arange(n), y % 32] = 255
        return x, y

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)
    return xtr, ytr, xte, yte


def normalize(x_uint8: np.ndarray) -> np.ndarray:
    return (x_uint8.astype(np.float32) / 255.0 - CIFAR_MEAN) / CIFAR_STD


def augment(x_uint8: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Reflect-pad 4 + random flip + random crop 32 (test_model.py:269)."""
    n = len(x_uint8)
    padded = np.pad(x_uint8, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(x_uint8)
    tops = rng.randint(0, 9, n)
    lefts = rng.randint(0, 9, n)
    flips = rng.rand(n) < 0.5
    for i in range(n):
        img = padded[i, tops[i]:tops[i] + 32, lefts[i]:lefts[i] + 32]
        out[i] = img[:, ::-1] if flips[i] else img
    return out


def build_bench_model(args, n_classes: int, n_batches: int):
    """(model, optimizer spec, make_optimizer keywords) of the subcommand:
    the JAX bench's per-arch optimizer and schedule (test_model.py:283-312),
    linear warmup over ``lr_warmup_epochs``. The model is seeded from
    ``--seed``, f32, on the CPU."""
    attn = None
    if args.attn:
        attn = AttnParams(args.attn_k, args.attn_v, args.attn_nh, args.attn_relative,
                          tuple(args.input_dims))
    layout = attn_layout_from_env()
    kw = {"warmup_steps": args.lr_warmup_epochs * n_batches, "warmup_style": "linear"}
    if args.model == "efficientnet":
        model = EfficientNet(f"efficientnet-{args.architecture}", num_classes=n_classes)
        spec = OptimizerSpec("rmsprop", "exponential", decay_factor=args.lr_decay_factor,
                             decay_steps=max(1, int(args.lr_decay_epochs * n_batches)))
    elif args.model in ("resnet", "wideresnet"):
        if args.model == "resnet":
            model = ResNet("bottleneck", RESNET_LAYERS[args.architecture], num_classes=n_classes,
                           attn=attn, attn_impl=args.attn_impl, attn_layout=layout)
        else:
            d, w = args.architecture
            model = WideResNet(d, w, num_classes=n_classes, attn=attn, attn_impl=args.attn_impl,
                               attn_layout=layout)
        spec = OptimizerSpec("sgd_nesterov", "cosine", weight_decay=args.weight_decay)
        kw["cosine_decay_steps"] = args.lr_cos_max_epochs * n_batches
    elif args.model == "densenet":
        k, L = args.architecture
        model = DenseNet(k, ((L - 4) // 6,) * 3, 2 * k, num_classes=n_classes, attn=attn,
                         attn_impl=args.attn_impl, attn_layout=layout)
        spec = OptimizerSpec("sgd_nesterov", "multistep",
                             milestones=(100 * n_batches, 150 * n_batches),
                             weight_decay=args.weight_decay)
    else:
        raise RuntimeError("Model not supported.")
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    return model, spec, kw


def topk_accuracy(logits: np.ndarray, y: np.ndarray, ks=(1, 5)):
    """(test_model.py:98-102)"""
    order = np.argsort(-logits, axis=1)
    return [float(np.mean([(y[i] in order[i, :k]) for i in range(len(y))])) for k in ks]


def train_step(model, optimizer, scheduler, x: torch.Tensor, y: torch.Tensor,
               compute_dtype: torch.dtype, generator=None) -> torch.Tensor:
    """One optimizer step of the mean log-softmax cross-entropy (f32) on a
    prepared (B, 3, 32, 32) batch; returns the loss on the device."""
    model.train()
    with autocast(x.device, compute_dtype):
        out = model(x, generator=generator)
    loss = F.cross_entropy(out.float(), y)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return loss.detach()


def to_device(x_uint8: np.ndarray, device) -> torch.Tensor:
    """Normalized NHWC uint8 images -> (B, 3, 32, 32) f32 on ``device``."""
    return torch.from_numpy(normalize(x_uint8)).to(device).permute(0, 3, 1, 2).contiguous()


def evaluate(model, x: np.ndarray, y: np.ndarray, batch_size: int, device,
             compute_dtype: torch.dtype) -> Tuple[float, float, float]:
    """(loss, top-1, top-5) over the full batches of (x, y), as the JAX bench
    drops the last partial one."""
    logits_all = []
    n = len(x)
    for s in range(0, n - n % batch_size, batch_size):
        logits_all.append(eval_logits(model, to_device(x[s:s + batch_size], device),
                                      compute_dtype).cpu().numpy())
    logits = np.concatenate(logits_all) if logits_all else np.zeros((0, 1))
    yy = y[:len(logits)]
    logp = logits - logits.max(1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(1, keepdims=True))
    loss = float(-logp[np.arange(len(yy)), yy].mean()) if len(yy) else float("nan")
    top1, top5 = topk_accuracy(logits, yy) if len(yy) else (0.0, 0.0)
    return loss, top1, top5


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    create_mesh(args.data_parallel, 1)  # one device: a larger mesh raises
    if not args.output_dir:
        args.output_dir = os.path.join(
            "results", args.model, time.strftime("%Y-%m-%d_%H-%M-%S", time.gmtime()))
    os.makedirs(args.output_dir, exist_ok=True)
    writer = MetricsWriter(args.output_dir)
    try:
        save_json(vars(args), "config", args.output_dir)
        _run(args, device, writer)
    finally:
        writer.close()
    return 0


def _run(args, device: torch.device, writer: MetricsWriter) -> None:
    n_classes = 10 if args.dataset == "cifar10" else 100
    if args.synthetic:
        xtr, ytr, xte, yte = synthetic_cifar(n_classes, seed=args.seed)
    else:
        xtr, ytr, xte, yte = load_cifar(args.data_dir, args.dataset)
    if args.mini_data:
        xtr, ytr = xtr[:args.batch_size], ytr[:args.batch_size]
        xte, yte = xtr, ytr
    n_batches = max(1, len(xtr) // args.batch_size)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model, spec, kw = build_bench_model(args, n_classes, n_batches)
    step = 0
    if args.restore:
        print(f"Restoring model weights from {args.restore}")
        ck = load_model_checkpoint(args.restore)
        model.load_state_dict(ck["state_dict"], strict=True)
        step = ck["global_step"]
    model = model.to(device)
    optimizer, scheduler, sched = make_optimizer(spec, model.parameters(), args.lr, **kw)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.restore:
        optim_path = os.path.join(os.path.dirname(args.restore),
                                  "optim_" + os.path.basename(args.restore))
        if os.path.exists(optim_path):
            load_optim_checkpoint(optim_path, optimizer, scheduler, generator)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Loaded {args.model}-{args.architecture} (number of parameters: {n_params:,}) "
          f"on {device}")

    rng = np.random.RandomState(args.seed)
    if args.train:
        for epoch in range(args.n_epochs):
            order = rng.permutation(len(xtr)) if not args.mini_data else np.arange(len(xtr))
            for s in range(0, len(xtr) - len(xtr) % args.batch_size, args.batch_size):
                idx = order[s:s + args.batch_size]
                xb = xtr[idx] if args.mini_data else augment(xtr[idx], rng)
                yb = torch.from_numpy(ytr[idx].astype(np.int64)).to(device)
                loss = train_step(model, optimizer, scheduler, to_device(xb, device), yb,
                                  dtype, generator)
                step += 1
                if step % args.log_interval == 0:
                    lv = float(loss)
                    writer.add_scalar("train_loss", lv, step)
                    writer.add_scalar("lr", sched(step - 1), step)
                    print(f"epoch {epoch + 1}/{args.n_epochs} step {step} loss {lv:.4f}")
            if (epoch + 1) % args.eval_interval == 0 or epoch == args.n_epochs - 1:
                loss, top1, top5 = evaluate(model, xte, yte, args.batch_size, device, dtype)
                print(f"Evaluate @ step {step}: loss {loss:.4f}; acc@1 {top1:.4f}; "
                      f"acc@5 {top5:.4f}")
                writer.add_scalar("eval_loss", loss, step)
                writer.add_scalar("acc@top1", top1, step)
                writer.add_scalar("acc@top5", top5, step)
                save_model_checkpoint(os.path.join(args.output_dir, "checkpoint.pt"),
                                      model.state_dict(), step)
                save_optim_checkpoint(os.path.join(args.output_dir, "optim_checkpoint.pt"),
                                      optimizer, scheduler, generator)

    if args.evaluate:
        loss, top1, top5 = evaluate(model, xte, yte, args.batch_size, device, dtype)
        print(f"Evaluate @ step {step}: loss {loss:.4f}; acc@1 {top1:.4f}; acc@5 {top5:.4f}")

    if args.vis_attn:
        if not args.attn:
            raise AssertionError("Enable --attn flag to visualize attention.")
        from chexpert_tpu_torch.interpret import capture_attention_weights, save_attn_maps

        x = xte[:8]
        weights = capture_attention_weights(model, to_device(x, device), compute_dtype=dtype)
        os.makedirs(os.path.join(args.output_dir, "vis"), exist_ok=True)
        names = [str(i) for i in range(len(x))]
        for i in range(len(x)):
            save_attn_maps(x.astype(np.float32) / 255.0, weights, names, list(range(len(x))),
                           args.output_dir, i)


if __name__ == "__main__":
    raise SystemExit(main())
