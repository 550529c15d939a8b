"""Run one cell of a benchmark tree on the CPU, as run.py does past its
look for a card, optionally with the timed path broken underneath (a
fault) or the control in the program's place; print the result line.

    python harness_drive.py TREE CELL SEED SECONDS TRACE [FAULT] [CONTROL]

Faults: ``unchanged`` (the train step leaves the state as it was),
``half_batch`` (the step sees half of each batch, its mean over the rest),
``altered`` (the engine's answer is altered where it is produced).
CONTROL ``fp8``: the reference in float8 stands in for the program."""

import json
import sys
import time

T = time.perf_counter()


def fault_patches(fault: str):
    import torch
    import torch.nn.functional as F

    from chexpert_tpu_torch.cli import bench, serve
    from chexpert_tpu_torch.train import steps

    if fault == "unchanged":
        def unchanged_cifar(model, optimizer, scheduler, x, y, dtype, generator=None):
            with torch.no_grad(), steps.autocast(x.device, dtype):
                return F.cross_entropy(model(x).float(), y)

        def unchanged_chexpert(state, batch, dtype, device_crop=None):
            with torch.no_grad(), steps.autocast(batch["image"].device, dtype):
                out = state.model(steps.prepare_image(batch["image"]))
            return steps.train_loss(out, batch["label"], batch["mask"])

        bench.train_step = unchanged_cifar
        steps.train_step = unchanged_chexpert
    elif fault == "half_batch":
        cifar, chexpert = bench.train_step, steps.train_step

        def half_cifar(model, optimizer, scheduler, x, y, dtype, generator=None):
            n = x.shape[0] // 2
            return cifar(model, optimizer, scheduler, x[:n], y[:n], dtype, generator)

        def half_chexpert(state, batch, dtype, device_crop=None):
            n = batch["image"].shape[0] // 2
            return chexpert(state, {k: v[:n] for k, v in batch.items()}, dtype, device_crop)

        bench.train_step = half_cifar
        steps.train_step = half_chexpert
    elif fault == "altered":
        forward = serve.Engine.forward

        def altered(self, batch):
            out = forward(self, batch)
            out[:, 0] = 1.0 - out[:, 0]
            return out

        serve.Engine.forward = altered
    elif fault:
        raise SystemExit(f"unknown fault {fault!r}")
    # the loops import the program's names inside their functions, so the
    # patched modules' attributes are what they call; train.train_step is
    # the package's re-export
    import chexpert_tpu_torch.train as train_pkg

    train_pkg.train_step = steps.train_step


def main():
    tree, cell_name, seed, seconds, trace = sys.argv[1:6]
    fault = sys.argv[6] if len(sys.argv) > 6 else ""
    control = sys.argv[7] if len(sys.argv) > 7 else ""
    sys.path.insert(0, f"{tree}/benchmark")
    sys.path.insert(1, tree)
    import torch

    torch.manual_seed(0)
    import run
    from check import judge
    from core import find_cell

    cell = find_cell(cell_name)
    run.set_env(cell)
    fault_patches(fault)
    result, checks, out = run.run_cell(cell, int(seed), float(seconds), bool(int(trace)),
                                       torch.device("cpu"), T)
    if control:
        checks = judge(run.numbers(cell, out, control), cell.limits)
        result["correct"] = all(c["ok"] for c in checks.values())
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
