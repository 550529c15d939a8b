"""Input path: host time the train loop waits for its next batch (the
prefetched JPEG pipeline's next, or the bench's augment and copy), mean a
step over the window's steps outside the profiler."""

from core import HERE, load_module


def read(record):
    return load_module(HERE / "metrics" / "_train.py").span_mean_ms(record, "input.wait")
