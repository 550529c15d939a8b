"""What the training cells' readers share: span means and the device
trace's shares, over the window's steps."""

from __future__ import annotations

from bounds.peaks import PEAK_FLOPS


def span_mean_ms(record, name: str):
    """Mean duration (ms) of the spans ``name`` over the steps outside the
    profiler."""
    spans = record.of(name, profiled=False)
    return sum(s.ms for s in spans) / len(spans) if spans else None


def idle_share(record):
    """Share (%) of the traced window with no kernel, copy or memset on the
    card."""
    t = record.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(record):
    """The training FLOPs of the profiled steps' images (three forwards an
    image, counted from the configuration's shapes) over the profiled window,
    as a share (%) of 989 TFLOP/s."""
    t, c = record.trace, record.counters
    if not t or t["window_s"] <= 0 or not c.get("profiled_steps"):
        return None
    flops = c["train_flops_per_image"] * c["batch"] * c["profiled_steps"]
    return 100.0 * flops / t["window_s"] / PEAK_FLOPS["bf16"]


def attention_roofline(record):
    """Σ each AA attention call's bound (forward and whole backward, at the
    configuration's head widths and batch) over the device time of the
    kernels launched inside the harness's ranges around those calls (%)."""
    t, c = record.trace, record.counters
    if not t or not c.get("profiled_steps"):
        return None
    device_s = t["range_s"].get("bench.attn.fwd", 0.0) + t["range_s"].get("bench.attn.bwd", 0.0)
    if device_s <= 0:
        return None
    return 100.0 * c["attention_bound_ms_per_step"] * c["profiled_steps"] / 1e3 / device_s
