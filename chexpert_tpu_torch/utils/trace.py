"""The port's spans: named stretches of host time around the work of a layer
(a train step's phases, the input path's parts, each AA conv's attention),
kept in memory while the tracer is on.

    from chexpert_tpu_torch.utils import trace

    trace.enable()
    with trace.span("step.forward"):
        ...
    trace.disable()
    spans = trace.drain()

Off, the default, ``span`` returns one shared no-op context and keeps
nothing. On, each span keeps its name, its start and end on
``time.perf_counter()``, the thread that opened it, its meta, and:

  * ``parent``: the id of the innermost span open on the same thread; on a
    thread with none open (the autograd engine's device thread, which runs
    the attention backward while the caller waits in ``loss.backward()``),
    the innermost span open on the thread of the current train step;
  * ``step``: the id of the current train step, the open span named
    ``step`` (``STEP``), shared by every span opened while it is open.

While a ``torch.profiler`` records, each span is also a
``torch.profiler.record_function`` range of the same name around the span,
so the profiler's trace places it on the device's timeline: operators read
the names in the trace of ``cli/chexpert.py --profile``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import List, Optional

import torch.autograd.profiler as _profiler

STEP = "step"


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    thread: int
    id: int
    parent: Optional[int]
    step: Optional[int]
    meta: dict


_OFF = contextlib.nullcontext()  # the tracer off: nothing is opened or kept
_on = False
_kept: list = []  # Span fields, as tuples
_ids = itertools.count()
_local = threading.local()
_step = None  # the open step span, or None


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "meta", "stack", "id", "parent", "step", "outer", "range", "start")

    def __init__(self, name: str, meta: dict):
        self.name, self.meta = name, meta

    def __enter__(self):
        global _step
        stack = self.stack = _stack()
        self.outer = _step
        owner = stack or (_step.stack if _step is not None else ())
        self.parent = owner[-1].id if owner else None
        self.id = next(_ids)
        if self.name == STEP:
            _step = self
        self.step = _step.id if _step is not None else None
        stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:  # set while any torch.profiler records
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter()

    def __exit__(self, *exc):
        global _step
        end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        if self.name == STEP:
            _step = self.outer
        _kept.append((self.name, self.start, end, threading.get_ident(), self.id,
                      self.parent, self.step, self.meta))
        return False


def span(name: str, **meta):
    """A context around one stretch of work named ``name``; ``meta`` is kept
    with it (map sizes, head counts)."""
    return _Open(name, meta) if _on else _OFF


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop keeping spans; those open close and are kept as usual."""
    global _on
    _on = False


def drain() -> List[Span]:
    """The spans kept so far, in the order they closed; forgets them."""
    global _kept
    out, _kept = _kept, []
    return [Span(*fields) for fields in out]
