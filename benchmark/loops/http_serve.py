"""Serving over HTTP, open loop: the program's server (``cli/serve.py::
serve``, a ThreadingHTTPServer around ``make_handler(Engine)``) in this
process on an ephemeral localhost port, at the CLI's defaults, with the
weights written as a checkpoint under TMPDIR. A client process
(``client.py``) sends one POST /predict of a seeded radiograph JPEG per
arrival of a Poisson schedule at a fixed rate, whatever is outstanding.
Latency runs from when a request was due to when its answer was read, so
a stall counts against the requests behind it.

Traffic keys: rate (requests/s), pool (distinct JPEGs), warmup_requests,
wait_s (how long past the window an answer may still come), lead_s (the
client's start before the first arrival), trace_seconds (the profiled part
of a traced run's window). Results: p50_ms, p90_ms, p95_ms (the
latency's percentiles over every request due in the window)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

import inputs
from core import HERE, now, percentile
from devtrace import Profiler
from loops.train_common import release
from reference.data import LABELS_5, radiograph_input, to_tensor
import weights as weights_mod


def _traced_engine(serve_mod, rec, t_from):
    """Spans (and profiler ranges) around Engine.predict / preprocess /
    forward, on the class, for the traced run; returns the undo."""
    from torch.profiler import record_function

    saved = {}
    for name in ("predict", "preprocess", "forward"):
        orig = getattr(serve_mod.Engine, name)
        saved[name] = orig

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            start = now()
            with record_function(f"bench.{_name}"):
                out = _orig(self, *a, **k)
            if start >= t_from[0]:
                rec.span(_name, start, now(), threading.get_ident())
            return out

        setattr(serve_mod.Engine, name, wrapped)

    def undo():
        for k, v in saved.items():
            setattr(serve_mod.Engine, k, v)

    return undo


def _traced_requests(httpd, rec, t_from):
    from torch.profiler import record_function

    orig = httpd.process_request_thread

    def wrapped(request, client_address):
        start = now()
        with record_function("bench.request"):
            orig(request, client_address)
        if start >= t_from[0]:
            rec.span("request", start, now(), threading.get_ident(), port=client_address[1])

    httpd.process_request_thread = wrapped


def _program(cell, ctx, root, files, dues, W_dev):
    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.cli import serve as serve_mod

    import client

    cfg, tr, rec = cell.config, cell.traffic, ctx.record
    ckpt = os.path.join(root, "weights.pt")
    save_model_checkpoint(ckpt, W_dev, 0)
    t_from = [float("inf")]
    undo = _traced_engine(serve_mod, rec, t_from) if ctx.trace else None
    args = serve_mod.build_parser().parse_args(
        ["--restore_path", ckpt, "--model", cfg["program"]["model"],
         "--image_size", str(cfg["image_size"]), "--host", "127.0.0.1", "--port", "0",
         "--compute_dtype", cfg["compute_dtype"],
         *cfg["program"].get("argv", [])])
    httpd = serve_mod.serve(args)
    if ctx.trace:
        _traced_requests(httpd, rec, t_from)
    server = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05})
    server.start()
    port = httpd.server_address[1]
    try:
        for i in range(tr["warmup_requests"]):
            with open(files[i % len(files)], "rb") as f:
                status, _, _ = client.request("127.0.0.1", port, f.read(), 60.0)
            if status != 200:
                raise RuntimeError(f"warm-up request answered {status}")
        prof = Profiler(ctx.trace, ctx.device)
        prof.start(now)
        proc = subprocess.Popen([sys.executable, str(HERE / "client.py")], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        t0 = now() + tr["lead_s"]
        t_from[0] = t0
        spec = {"host": "127.0.0.1", "port": port, "t0": t0, "dues": dues,
                "files": [files[j] for j in ctx.request_files], "wait_s": tr["wait_s"]}
        try:
            proc.stdin.write(json.dumps(spec))
            proc.stdin.close()
            if prof.running:
                left = t0 + tr["trace_seconds"] - now()
                if left > 0:
                    threading.Event().wait(left)
                prof.stop(now)
            out = proc.stdout.read()
        finally:
            if proc.wait(timeout=dues[-1] + tr["wait_s"] + 120) != 0:
                raise RuntimeError(f"client exited {proc.returncode}")
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    finally:
        httpd.shutdown()
        server.join()
        httpd.server_close()
        if undo is not None:
            undo()
    rec.trace = prof.summary() if ctx.trace else None
    return [json.loads(line) for line in out.splitlines() if line.strip()], t0, peak


def run(cell, ctx) -> dict:
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    root = tempfile.mkdtemp(prefix="serve-", dir=os.environ.get("TMPDIR"))
    try:
        pool = inputs.jpeg_pool(ctx.seed, tr["pool"], cfg["image_size"])
        files = []
        for i, data in enumerate(pool):
            files.append(os.path.join(root, f"request{i}.jpg"))
            with open(files[-1], "wb") as f:
                f.write(data)
        dues = inputs.poisson_dues(tr["rate"], ctx.seconds)
        # each request's JPEG: the pool in turn, in an order drawn from the seed
        perm = np.random.RandomState(inputs.seed32(ctx.seed) ^ 0xC0FFEE).permutation(len(dues))
        ctx.request_files = [int(p % len(pool)) for p in perm]
        W_dev = weights_mod.make(ref.shapes(cfg), ctx.seed, ctx.device)
        W = {k: v.cpu() for k, v in W_dev.items()}
        answers, t0, peak = _program(cell, ctx, root, files, dues, W_dev)
        del W_dev
        release()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    close = t0 + dues[-1] + tr["wait_s"]
    lat, failed = [], 0
    for a in answers:
        ok = a.get("status") == 200 and a.get("done") is not None
        failed += not ok
        lat.append(((a["done"] if ok else close) - a["due"]) * 1e3)
    late = [(a["sent"] - a["due"]) * 1e3 for a in answers]
    rec = ctx.record
    rec.extra["answers"] = answers
    rec.extra["window_start"] = t0
    metrics = {f"p{q}_ms": percentile(lat, q) for q in (50, 90, 95)}
    print(f"generator lateness: median {percentile(late, 50):.3f} ms, p95 "
          f"{percentile(late, 95):.3f} ms, max {max(late):.3f} ms over {len(late)} requests",
          file=sys.stderr)
    norm = cfg["normalization"]
    x = to_tensor(np.stack([radiograph_input(d, cfg["image_size"], norm["mean"], norm["std"])
                            for d in pool]), ctx.device)
    W_ref = {k: v.to(ctx.device) for k, v in W.items()}

    def reference(precision="f32", half=False):
        from reference.layers import no_tf32

        no_tf32()
        with torch.no_grad():
            probs = torch.sigmoid(ref.forward(W_ref, x, cfg, train=False, precision=precision))
        return probs.double().cpu().numpy()

    return {"metrics": metrics, "window_start": t0, "attempted": len(dues), "failed": failed,
            "memory_peak_bytes": peak, "reference": reference,
            "program": {"answers": answers, "files": ctx.request_files},
            "generator_late_ms": {"median": percentile(late, 50), "max": max(late)}}


def numbers(got, want: np.ndarray) -> dict:
    """The program's answers (or a control's probabilities for the pool, in
    its place) against the reference's probabilities for the pool."""
    if isinstance(got, np.ndarray):
        return {"prob_gap": float(np.abs(got - want).max()), "unanswered": 0}
    return serve_numbers(got, want)


def serve_numbers(program: dict, ref_probs: np.ndarray) -> dict:
    """prob_gap: the widest gap between a served probability and the
    reference's for the JPEG sent; unanswered: requests with no answer."""
    gap, missing = 0.0, 0
    for a in program["answers"]:
        body = a.get("body")
        if a.get("status") != 200 or not isinstance(body, dict):
            missing += 1
            continue
        want = ref_probs[program["files"][a["i"]]]
        got = np.array([body["probabilities"][n] for n in LABELS_5])
        gap = max(gap, float(np.abs(got - want).max()))
    return {"prob_gap": gap, "unanswered": missing}
