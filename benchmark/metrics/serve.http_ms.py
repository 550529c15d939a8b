"""HTTP front end: a request's round trip, as its client saw it from send to
answer, less its Engine.predict span; the median over the window."""

from core import median, load_module, HERE


def read(record):
    pairs = load_module(HERE / "metrics" / "_serve.py").round_trips(record)
    return median([rt - p.ms for rt, p in pairs])
