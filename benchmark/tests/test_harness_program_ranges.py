"""The program's own spans (``chexpert_tpu_torch/utils/trace.py``) appear in
a profiler's trace as ranges of their names while its tracer is on. The
device trace's reduction keys on the harness's ``bench.`` ranges alone, so
the program's ranges, mixed into a trace, leave its summary as it was."""

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from devtrace import summarize


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def program_ranges(monkeypatch, tmp_path):
    """The ranges a traced CIFAR bench step of the program opens on the CPU
    (WideResNet-10-2 with AA convs in the hil layout, batch 2)."""
    from chexpert_tpu_torch.cli import bench
    from chexpert_tpu_torch.train import make_optimizer
    from chexpert_tpu_torch.utils import trace

    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "hil")
    args = bench.build_parser().parse_args(
        ["wideresnet", "10", "2", "--attn", "--attn_nh", "2", "--device", "cpu"])
    model, spec, kw = bench.build_bench_model(args, 10, 2)
    opt, sched, _ = make_optimizer(spec, model.parameters(), args.lr, **kw)
    rng = np.random.RandomState(0)
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            x = bench.to_device(bench.augment(rng.randint(0, 256, (2, 32, 32, 3))
                                              .astype(np.uint8), rng), torch.device("cpu"))
            bench.train_step(model, opt, sched, x, torch.tensor([1, 2]), torch.float32)
        names = {s.name for s in trace.drain()}
    finally:
        trace.disable()
        trace.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] in names]


def test_summary_is_unchanged_by_the_programs_ranges(monkeypatch, tmp_path):
    harness = [
        ev("user_annotation", "bench.step", 0, 100),
        ev("user_annotation", "bench.attn.fwd", 10, 20),
        ev("user_annotation", "bench.attn.bwd", 60, 30, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 65, 1, tid=2, corr=3),
        ev("kernel", "attention_fwd_mma", 100, 30, tid=7, corr=1),
        ev("kernel", "cudnn_conv", 120, 40, tid=7, corr=2),
        ev("kernel", "attention_bwd", 200, 10, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 400, 10, tid=8),
        ev("user_annotation", "bench.input_wait", 150, 300),
    ]
    ranges = program_ranges(monkeypatch, tmp_path)
    names = {e["name"] for e in ranges}
    assert {"step", "step.forward", "step.backward", "step.optimizer", "attn.fwd",
            "attn.bwd", "input.augment", "input.to_device"} <= names
    assert not any(n.startswith("bench.") for n in names)
    # the program's ranges as recorded, and again laid over the harness's
    # (the same names around the same launches, on both threads)
    laid = [ev("user_annotation", "step", 0, 100), ev("user_annotation", "step.forward", 5, 50),
            ev("user_annotation", "attn.fwd", 11, 18), ev("user_annotation", "step.backward", 55, 45),
            ev("user_annotation", "attn.bwd", 61, 28, tid=2),
            ev("user_annotation", "input.augment", 150, 100)]
    want = summarize(harness, window_s=1e-3)
    assert summarize(harness + ranges + laid, window_s=1e-3) == want
    assert want["range_s"]["bench.attn.bwd"] > 0 and want["breakdown"]["idle_gaps"]
