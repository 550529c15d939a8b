#!/usr/bin/env python3
"""Where a served request's time goes in the PyTorch port, on one card.

    python3 scripts/profile_torch_serve.py [--model aadensenet121] [--attn_layout bn|hil]

Builds ``--model`` (aadensenet121 at 320x320 by default; aaresnet152 and
resnet152 at 320x320; efficientnet-b* at its own resolution in
SCALING_PARAMS) with seeded random weights, serves it with
chexpert_tpu_torch.cli.serve (bf16; ``--attn_layout`` sets the
CHEXPERT_ATTN_LAYOUT variable that the server's model build reads) and
measures, per request: the HTTP round trip, Engine.predict alone, its
preprocess and its forward (host clock around work that ends in a
synchronize; medians). Then profiles the forward with torch.profiler and
prints the device time by kernel name, the device busy share of the
forward's wall time, and the share of the port's forward kernels (B1
rel_attention_fwd, B3 depthwise_fwd, B5 hil_attention_fwd), then the
profiler's own table. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


MICRO_BATCH, REQUESTS = 4, 10  # as chip_smoke.py serves


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="aadensenet121")
    p.add_argument("--attn_layout", default=None, choices=["bn", "hil"])
    args = p.parse_args()
    if args.attn_layout is not None:
        os.environ["CHEXPERT_ATTN_LAYOUT"] = args.attn_layout
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    from PIL import Image

    from chexpert_tpu_torch.checkpoint import save_model_checkpoint
    from chexpert_tpu_torch.cli.serve import Engine, build_parser, make_handler
    from chexpert_tpu_torch.models import build_model
    from chexpert_tpu_torch.models.efficientnet import SCALING_PARAMS
    from http.server import ThreadingHTTPServer

    name = args.model
    size = SCALING_PARAMS[name][2] if name in SCALING_PARAMS else 320

    rng = np.random.RandomState(0)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (size + 16, size + 24), dtype=np.uint8), "L").save(
        buf, "JPEG")
    jpeg = buf.getvalue()
    model = build_model(name, image_size=size, generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        ckpt = os.path.join(d, "w.pt")
        save_model_checkpoint(ckpt, model.state_dict())
        engine = Engine(build_parser().parse_args([
            "--restore_path", ckpt, "--model", name, "--image_size", str(size),
            "--device", "cuda", "--compute_dtype", "bfloat16",
            "--micro_batch", str(MICRO_BATCH)]))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"

    def http():
        req = urllib.request.Request(url, data=jpeg, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            json.loads(r.read())

    batch = np.zeros((MICRO_BATCH, size, size, 3), np.float32)
    batch[0] = engine.preprocess(jpeg)
    try:
        res = {
            "http_ms": _median_ms(http, REQUESTS),
            "predict_ms": _median_ms(lambda: engine.predict(jpeg), REQUESTS),
            "preprocess_ms": _median_ms(lambda: engine.preprocess(jpeg), REQUESTS),
            "forward_ms": _median_ms(lambda: engine.forward(batch), REQUESTS),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n = 3  # profiled forwards; every number below is per forward
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.forward(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    avgs = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev = sorted(((getattr(e, attr) / 1e3 / n, e.count // n, e.key) for e in avgs
                  if getattr(e, attr) > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
                 reverse=True)
    if not dev:
        print("profile_torch_serve: the profiler recorded no device time", file=sys.stderr)
        return 1
    busy_ms = sum(t for t, _, _ in dev)
    res.update({"model": name, "image_size": size, "profiled_wall_ms": wall_ms,
                "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
                **{f"{kernel}_ms": sum(t for t, _, k in dev if kernel in k)
                   for kernel in ("rel_attention_fwd", "depthwise_fwd", "hil_attention_fwd")},
                "attn_layout": os.environ.get("CHEXPERT_ATTN_LAYOUT", "bn"),
                "device_kernels": sum(c for _, c, _ in dev)})
    print("device time by kernel (ms, launches, name):")
    for t, c, k in dev[:15]:
        print(f"  {t:9.3f} {c:5d}  {k[:110]}")
    print(avgs.table(sort_by=attr, row_limit=30))
    smi = os.popen("nvidia-smi -i 0 --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({**res, "micro_batch": MICRO_BATCH, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
