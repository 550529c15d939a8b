"""A copy of the benchmark's folder with tiny cells (CPU sizes), and a way
to run a cell of it in a fresh process (``harness_drive.py``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

TINY_WRN_ARGV = ["wideresnet", "10", "4", "--attn", "--train", "--synthetic", "--attn_k", "0.2",
                 "--attn_v", "0.1", "--attn_nh", "2", "--lr", "0.016", "--weight_decay", "1e-05",
                 "--lr_warmup_epochs", "5", "--lr_cos_max_epochs", "25", "--compute_dtype",
                 "bfloat16"]
# limits for the tiny cells, from CPU readings of sound runs and of the fp8
# control at these sizes
TINY_TRAIN_LIMITS = {"logit_gap": 0.02, "grad_gap_median": 0.05, "change_gap_median": 0.02,
                     "rows_mismatched": 0}
TINY_SERVE_LIMITS = {"prob_gap": 0.015, "unanswered": 0}
# the tiny Adam cell's limits, from CPU readings likewise (PERF.md), on the
# readings that separate under Adam
TINY_ADAM_LIMITS = {"logit_gap": 0.02, "grad_gap_median": 0.05, "change_gap_median": 0.1,
                    "rows_mismatched": 0}
# the real cells whose metrics the tiny cells report
TINY_OF = {"wrn28-10-aa-hil.train": ["tiny-wrn.train"],
           "aaresnet152-hil.train": ["tiny-dn.train", "tiny-dna.train"]}


def make_tree(dst: Path) -> Path:
    """dst/benchmark (a copy) and dst/BENCHMARK.json with tiny cells:
    tiny-dn.train (SGD), tiny-dna.train (aadensenet-tiny, Adam, the
    aaresnet152-hil cell's optimizer), tiny-wrn.train and tiny-dn.serve."""
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    cfgs = dst / "benchmark" / "configs"
    dn = json.loads((cfgs / "aadensenet121.json").read_text())
    dn.update(name="tiny-dn", image_size=64)
    dn["program"] = dict(dn["program"], argv=["--device", "cpu"])
    wrn = json.loads((cfgs / "wrn28-10-aa-hil.json").read_text())
    wrn.update(name="tiny-wrn", depth=10, width=4, attn=dict(wrn["attn"], nh=2))
    wrn["program"] = dict(wrn["program"], argv=TINY_WRN_ARGV)
    wrn["optimizer"] = dict(wrn["optimizer"], warmup_steps=5 * 16, cosine_steps=25 * 16)
    dna = dict(dn, name="tiny-dna", image_size=32, stem="cifar", growth_rate=8,
               block_config=[2, 2], num_init_features=16,
               attn=dict(dn["attn"], k=0.25, v=0.25, nh=2),
               program={"model": "aadensenet-tiny", "attn_layout": "hil"},
               env={"CHEXPERT_ATTN_LAYOUT": "hil"},
               optimizer=json.loads((cfgs / "aaresnet152-hil.json").read_text())["optimizer"])
    for c in (dn, wrn, dna):
        (cfgs / f"{c['name']}.json").write_text(json.dumps(c))
    traffic = dst / "benchmark" / "traffic"
    (traffic / "tiny_chexpert.json").write_text(json.dumps(
        {"loop": "chexpert_train", "rows": 64, "pool": 5, "batch": 4, "workers": 2,
         "prefetch": 2, "warmup_steps": 1, "log_interval": 2, "trace_steps": 2,
         "reports": {"chexpert_img_per_s": "img_per_s"}}))
    (traffic / "tiny_cifar.json").write_text(json.dumps(
        {"loop": "cifar_train", "n_train": 64, "batch": 4, "warmup_steps": 1,
         "log_interval": 1, "trace_steps": 2, "reports": {"cifar_img_per_s": "img_per_s"}}))
    (traffic / "tiny_serve.json").write_text(json.dumps(
        {"loop": "http_serve", "rate": 4.0, "pool": 3, "warmup_requests": 2, "wait_s": 30.0,
         "lead_s": 0.3, "trace_seconds": 1.0,
         "reports": {"serve_p50_ms": "p50_ms", "serve_p90_ms": "p90_ms"}}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": "tiny-dn", "source": "test", "file": "benchmark/configs/tiny-dn.json",
         "reduced": [], "why": "CPU test size"},
        {"name": "tiny-wrn", "source": "test", "file": "benchmark/configs/tiny-wrn.json",
         "reduced": [], "why": "CPU test size"},
        {"name": "tiny-dna", "source": "test", "file": "benchmark/configs/tiny-dna.json",
         "reduced": [], "why": "CPU test size"}]
    cells = {"tiny-dn.train": ("tiny-dn", "tiny_chexpert", TINY_TRAIN_LIMITS),
             "tiny-wrn.train": ("tiny-wrn", "tiny_cifar", TINY_TRAIN_LIMITS),
             "tiny-dn.serve": ("tiny-dn", "tiny_serve", TINY_SERVE_LIMITS),
             "tiny-dna.train": ("tiny-dna", "tiny_chexpert", TINY_ADAM_LIMITS)}
    for name, (cfg, tr, limits) in cells.items():
        bench["workloads"].append({"name": name, "config": cfg, "traffic": tr, "chips": 1,
                                   "why": "CPU test size"})
        (dst / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps(limits))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for w in list(m["workloads"]) for t in TINY_OF[w]]
    # the serving metrics, as a benchmark change that adds a serving cell
    # would list them (their readers are in metrics/)
    bench["end_to_end"] += [
        {"name": n, "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
         "workloads": ["tiny-dn.serve"]} for n in ("serve_p50_ms", "serve_p90_ms")]
    bench["per_layer"] += [
        {"name": n, "unit": u, "better": "lower", "source": "program_span", "layer": n,
         "moves": "serve_p50_ms", "workloads": ["tiny-dn.serve"]}
        for n, u in (("serve.http_ms", "ms"), ("serve.queue_ms", "ms"),
                     ("serve.preprocess_ms", "ms"), ("serve.forward_ms", "ms"),
                     ("serve.device_idle_share", "%"))]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def drive(tree: Path, cell: str, seed: int = 7, seconds: float = 1.0, trace: int = 0,
          fault: str = "", control: str = "", timeout: float = 600) -> dict:
    """Run ``cell`` of ``tree`` on the CPU in a fresh process; returns the
    result line (with "checks")."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    out = subprocess.run(
        [sys.executable, str(BENCH / "tests" / "harness_drive.py"), str(tree), cell, str(seed),
         str(seconds), str(trace), fault, control],
        capture_output=True, text=True, timeout=timeout, env=env)
    if out.returncode != 0:
        raise AssertionError(f"drive {cell} {fault or control}: exit {out.returncode}\n"
                             f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])
