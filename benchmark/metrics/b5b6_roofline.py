"""The heads-in-lanes attention kernels (B5 forward, B6 backward) against their
bounds (%), over the AA convs' attention calls (metrics/_train.py)."""

from core import HERE, load_module


def read(record):
    return load_module(HERE / "metrics" / "_train.py").attention_roofline(record)
