#!/usr/bin/env python3
"""Multi-process training of the port on N cards of one host: train step
time per world size under NCCL, and a world of N against one process at
the same global batch.

    python3 scripts/ddp_scaling_torch.py [--model aadensenet121] [--image_size 320]
        [--per_rank_batch 16] [--steps 6] [--worlds 1,2,4] [--out F]

For each world size W (at most the card count) it starts W processes of
``python -m chexpert_tpu_torch.cli.chexpert --train --multihost`` with
torchrun's variables (rank r on card r), bf16, global batch W x
--per_rank_batch, --steps steps in one epoch on the port's synthetic
fixture (OMP_NUM_THREADS=1 in each rank, as torchrun sets it, unless the
environment sets it), and reads rank 0's images/s (global images): the median over
steps 2.. gives ms/step, and the scaling efficiency is img/s over W times
world 1's. Then, at the largest W, the same global batch (W x 2 rows) in
f32 (TF32 off through NVIDIA_TF32_OVERRIDE=0) at lr 1e-4 for 3 steps as W
processes and as one: the loss of each step and the first step's relative
difference (one forward of the same global batch, no update yet).

Prints one JSON line (and writes it to --out): the card (nvidia-smi name
and power limit), torch and CUDA versions, per world the ms/step, img/s,
efficiency and every step's img/s, and the check's losses. --profile runs
each world's ranks through this script, rank 0 tracing steps 3 and 4
(torch.profiler: the ops by device and by host time), with NCCL_DEBUG=INFO
(the transport NCCL picked between the cards); the traced steps then run
under the profiler, so take ms/step from a run without --profile.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CLI = ["-m", "chexpert_tpu_torch.cli.chexpert"]


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scalars(run_dir: str, tag: str) -> list:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r.get("tag") == tag]


def launch(world: int, argv: list, extra_env: dict, timeout: float = 900) -> list:
    """``python argv`` as ``world`` ranks, rank r on card r, ``extra_env`` in
    each one's environment, and OMP_NUM_THREADS=1 unless the caller's
    environment sets it (torchrun's default for several processes); returns
    each rank's (stdout, stderr), and raises with the failing rank's output
    if any rank fails."""
    port, procs, files = free_port(), [], []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **extra_env,
                       OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"),
                       PYTHONPATH=os.pathsep.join([str(ROOT),
                                                   os.environ.get("PYTHONPATH", "")]))
            # files, not pipes: a rank blocked on a full pipe would hold the
            # others in their next collective
            files.append((tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, text=True,
                                          stdout=files[-1][0], stderr=files[-1][1]))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        logs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            logs.append((out.read(), err.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {world} exited {p.returncode}:\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
    return logs


def train_args(data: str, out: str, model: str, image: int, batch: int, steps: int,
               dtype: str, lr: float) -> list:
    return [*CLI, "--train", "--data_path", data, "--output_dir", out, "--model", model,
            "--image_size", str(image), "--batch_size", str(batch), "--n_epochs", "1",
            "--lr", str(lr), "--log_interval", "1", "--eval_interval", "0",
            "--compute_dtype", dtype, "--multihost"]


def profiled_rank(argv: list) -> int:
    """One rank running cli.chexpert.main ``argv``; rank 0 traces steps 3
    and 4 with torch.profiler and prints the ops by self device time and by
    self host time, the device time summed over kernels, and the wall."""
    from chexpert_tpu_torch.cli.chexpert import main as cli_main
    from chexpert_tpu_torch.train import loop

    step, traced = loop.train_step, os.environ.get("RANK") == "0"
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    t0 = [0.0]

    def train_step(state, batch, *args):
        if traced and state.step == 2:
            torch.cuda.synchronize()
            prof.start()
            t0[0] = time.perf_counter()
        loss = step(state, batch, *args)
        if traced and state.step == 4:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0[0]) * 1e3
            prof.stop()
            events = prof.key_averages()
            # kernels only: a host range such as DDP's forward carries its
            # kernels' device time too
            device = sum(e.self_device_time_total for e in events
                         if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            host = sum(e.self_cpu_time_total for e in events) / 1e3
            print(f"PROFILE 2 steps: wall {wall:.2f} ms, host time summed over ops "
                  f"{host:.2f} ms, device time summed over kernels {device:.2f} ms")
            for key in ("self_device_time_total", "self_cpu_time_total"):
                print(events.table(sort_by=key, row_limit=12, max_name_column_width=60))
        return loss

    loop.train_step = train_step
    return cli_main(argv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="aadensenet121")
    p.add_argument("--image_size", type=int, default=320)
    p.add_argument("--per_rank_batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--worlds", default="1,2,4")
    p.add_argument("--out", default="")
    p.add_argument("--profile", action="store_true",
                   help="trace steps 3-4 of rank 0 at each world size (torch.profiler) and "
                        "print NCCL's transport (NCCL_DEBUG=INFO)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ddp_scaling_torch: no CUDA device is available")
    from chexpert_tpu_torch import kernels
    from chexpert_tpu_torch.data import make_synthetic_dataset
    from chexpert_tpu_torch.ops import kernel_targets

    kernels.build(kernel_targets())  # once, here, before the ranks load the libraries
    cards = torch.cuda.device_count()
    worlds = [w for w in map(int, args.worlds.split(",")) if w <= cards]
    record = {"card": smi_line(), "cards": cards, "torch": torch.__version__,
              "omp_num_threads": os.environ.get("OMP_NUM_THREADS", "1"),
              "cuda": torch.version.cuda, "model": args.model, "image": args.image_size,
              "per_rank_batch": args.per_rank_batch, "steps": args.steps, "worlds": {}}
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        for w in worlds:
            batch = w * args.per_rank_batch
            data = os.path.join(d, f"data{w}")
            make_synthetic_dataset(data, n_train=batch * args.steps, n_valid=batch,
                                   image_size=args.image_size)
            out = os.path.join(d, f"world{w}")
            cli = train_args(data, out, args.model, args.image_size, batch, args.steps,
                             "bfloat16", 0.01)
            if args.profile:  # this script as each rank, rank 0 traced
                cli = [str(Path(__file__).resolve()), "--rank", *cli[len(CLI):]]
            logs = launch(w, cli, {"NCCL_DEBUG": "INFO"} if args.profile else {})
            if args.profile:
                print("\n".join(line for line in logs[0][0].splitlines()
                                if " via " in line or not line.startswith(("epoch", "Load",
                                                                            "Train", "Valid")))
                      , flush=True)
            ips = scalars(out, "images_per_sec")
            med = statistics.median(ips[1:])
            record["worlds"][w] = {"global_batch": batch, "ms_per_step": batch / med * 1e3,
                                   "images_per_sec": med, "images_per_sec_by_step": ips}
            base = record["worlds"][worlds[0]]["images_per_sec"] / worlds[0]
            record["worlds"][w]["efficiency"] = med / (w * base)
            print(f"world {w}: global batch {batch}, {batch / med * 1e3:.2f} ms/step, "
                  f"{med:.1f} img/s, efficiency {record['worlds'][w]['efficiency']:.3f} "
                  f"(img/s by step {[round(x, 1) for x in ips]})", flush=True)
        w = max(worlds)
        if w > 1:
            batch = 2 * w
            data = os.path.join(d, "check")
            make_synthetic_dataset(data, n_train=batch * 3, n_valid=batch,
                                   image_size=args.image_size)
            losses = {}
            for world in (w, 1):
                out = os.path.join(d, f"check{world}")
                # f32 without TF32 in cuDNN and cuBLAS, asked of every rank
                launch(world, train_args(data, out, args.model, args.image_size, batch, 3,
                                         "float32", 1e-4), {"NVIDIA_TF32_OVERRIDE": "0"})
                losses[world] = scalars(out, "train_loss")
            first = abs(losses[w][0] - losses[1][0]) / max(losses[1])
            record["check"] = {"world": w, "global_batch": batch, "losses": losses,
                               "first_step_max_rel_d": first,
                               "max_rel_d": max(abs(a - b) for a, b in
                                                zip(losses[w], losses[1])) / max(losses[1])}
            print(f"check: world {w} vs 1, f32, global batch {batch}, lr 1e-4: losses "
                  f"{losses[w]} vs {losses[1]}; first step |d| / max loss {first:.3g}, all "
                  f"{record['check']['max_rel_d']:.3g}", flush=True)
    line = json.dumps(record)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(profiled_rank(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
