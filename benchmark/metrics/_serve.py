"""Pairing of a served request's spans: the client's record (by its port)
with the server's request span, and the Engine spans on that thread."""

from __future__ import annotations


def _within(spans, outer):
    return [s for s in spans if s.thread == outer.thread and outer.start <= s.start <= outer.end]


def predicts(record):
    """(predict, [preprocess], [forward]) for every predict span of the window."""
    pre, fwd = record.of("preprocess"), record.of("forward")
    return [(p, _within(pre, p), _within(fwd, p)) for p in record.of("predict")]


def round_trips(record):
    """(client round trip ms, predict span) per answered request."""
    reqs = {}
    for s in record.of("request"):
        reqs.setdefault(s.meta.get("port"), []).append(s)
    preds = record.of("predict")
    out = []
    for a in record.extra.get("answers", []):
        if a.get("status") != 200 or a.get("done") is None:
            continue
        cands = [s for s in reqs.get(a.get("port"), ()) if a["sent"] - 1.0 <= s.start <= a["done"]]
        if not cands:
            continue
        req = min(cands, key=lambda s: abs(s.start - a["sent"]))
        inner = _within(preds, req)
        if inner:
            out.append(((a["done"] - a["sent"]) * 1e3, inner[0]))
    return out
