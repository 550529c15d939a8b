"""Engine lock: Engine.predict less its preprocess and forward, i.e. the
wait for the lock (and the batch's assembly); the 90th percentile, the
highest with ten requests beyond it in a window."""

from core import HERE, load_module, percentile


def read(record):
    rows = load_module(HERE / "metrics" / "_serve.py").predicts(record)
    return percentile([p.ms - sum(s.ms for s in pre) - sum(s.ms for s in fwd)
                       for p, pre, fwd in rows if pre and fwd], 90)
