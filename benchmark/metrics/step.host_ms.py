"""Train step: host time from the step's call to its return (dispatch, and
what the step waits for), mean a step over the window's steps outside the
profiler."""

from core import HERE, load_module


def read(record):
    return load_module(HERE / "metrics" / "_train.py").span_mean_ms(record, "step.host")
