"""Device: share (%) of the profiled steps' window with no kernel, copy or
memset on the card."""

from core import HERE, load_module


def read(record):
    return load_module(HERE / "metrics" / "_train.py").idle_share(record)
