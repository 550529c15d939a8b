"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
over part of the window, read back from its Chrome trace.

  * busy: the union of the intervals in which a kernel, copy or memset ran
    on the card; the window is the host's wall time of the profiled part;
  * ranges: ``torch.profiler.record_function`` ranges opened by the
    harness (``bench.*``); a kernel belongs to a range when the host call
    that launched it (matched by CUPTI's correlation id) lies inside it on
    the same thread;
  * breakdown: device time by kernel group, and idle time by the harness
    range the host was in when each gap began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

# groups of device kernels by the first pattern in the name (chip_smoke.py's
# KERNEL_GROUPS, copied, with cuBLAS's Hopper GEMMs, "nvjet_*", as GEMMs)
KERNEL_GROUPS = (("attention", ("attention_",)), ("depthwise", ("depthwise_",)),
                 ("layout copies", ("nchwToNhwc", "nhwcToNchw")),
                 ("batch norm", ("batch_norm",)),
                 ("conv and gemm", ("xmma", "gemm", "conv", "cutlass", "cudnn", "nvjet")))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_group(name: str) -> str:
    return next((g for g, pats in KERNEL_GROUPS if any(p in name for p in pats)), "other")


class Profiler:
    """Start / stop ``torch.profiler`` around the profiled part of a window
    (a no-op when ``enabled`` is false); ``summary()`` reads the trace."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    def start(self, now):
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = now()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def stop(self, now):
        if not self.running:
            return
        torch.cuda.synchronize(self.device)
        self.t1 = now()
        self.prof.stop()

    def summary(self):
        if self.prof is None or self.t1 is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return summarize(events, self.t1 - self.t0)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_s: float) -> dict:
    """busy_s, window_s, the device seconds of each harness range, and the
    breakdown (at most 10 entries a list)."""
    dev, launches, ranges = [], {}, defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["ts"], e.get("pid"), e.get("tid"))
        elif cat == "user_annotation" and e.get("name", "").startswith("bench."):
            ranges[e["name"]].append((e["ts"], e["ts"] + e.get("dur", 0), e.get("pid"),
                                      e.get("tid")))
    busy = _union((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    busy_us = sum(e - s for s, e in busy)

    range_us = defaultdict(float)
    by_thread = defaultdict(list)
    for name, spans in ranges.items():
        for s, e, pid, tid in spans:
            by_thread[(pid, tid)].append((s, e, name))
    for key in by_thread:
        by_thread[key].sort()
    groups = defaultdict(float)
    for e in dev:
        dur = e.get("dur", 0)
        cat = e.get("cat")
        groups[kernel_group(e.get("name", "")) if cat == "kernel" else
               cat.replace("gpu_", "")] += dur
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        ts, pid, tid = launch
        spans = by_thread.get((pid, tid), ())
        # innermost range holding the launch: the latest start at or before it
        hits = [name for s, en, name in spans if s <= ts <= en]
        if hits:
            range_us[hits[-1]] += dur

    # idle gaps inside the device's active span, named by the harness range
    # the host was in when each began (innermost, on any thread)
    all_ranges = sorted((s, e, n) for spans in by_thread.values() for s, e, n in spans)
    starts = [s for s, _, _ in all_ranges]
    idle = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, e0)
        name = "no harness range"
        for s, e, n in reversed(all_ranges[max(0, i - 64):i]):
            if s <= e0 <= e:
                name = n
                break
        idle[name] += s1 - e0

    def top(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "range_s": {k: v / 1e6 for k, v in range_us.items()},
            "breakdown": {"device_ops": top(groups), "idle_gaps": top(idle)}}
