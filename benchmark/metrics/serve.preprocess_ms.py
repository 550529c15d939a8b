"""Engine.preprocess (decode, crop, whiten) of a request; the median."""

from core import median


def read(record):
    return median([s.ms for s in record.of("preprocess")])
