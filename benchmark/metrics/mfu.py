"""The whole training step's share (%) of the card's bf16 peak
(metrics/_train.py::mfu)."""

from core import HERE, load_module


def read(record):
    return load_module(HERE / "metrics" / "_train.py").mfu(record)
