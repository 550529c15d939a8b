"""Device: share (%) of the traced part of the serving window with no
kernel, copy or memset on the card."""

from core import HERE, load_module


def read(record):
    return load_module(HERE / "metrics" / "_train.py").idle_share(record)
