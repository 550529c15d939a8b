"""Engine.forward (copy in, forward under autocast, sigmoid, copy out) of a
request; the median."""

from core import median


def read(record):
    return median([s.ms for s in record.of("forward")])
