"""What the harness finds by name, and the record a run leaves for the
per-layer readers.

``BENCHMARK.json`` at the checkout's root lists the cells. A cell names a
configuration and a traffic mix; each lives in a file of its own that the
harness finds by that name:

  * ``configs/<config>.json``: the sizes as run, and ``reference``, the
    module under ``reference/`` that computes the same model plainly;
  * ``traffic/<traffic>.json``: ``loop``, the module under ``loops/`` that
    drives the program, that loop's parameters (rates, batch, pool), and
    ``reports``: which of the loop's results each end-to-end metric is;
  * ``limits/<cell>.json``: the limit of each number that decides
    ``correct``;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record)``
    returning a number or None where the run has nothing to read; a metric
    split by cell (``<metric>.<suffix>``) may share the reader of the name
    before its last dot.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


def root_of(here: Path = HERE) -> Path:
    return here.parent


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Import a file of the harness by its path (names may hold dots)."""
    name = name or "benchmark_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    here: Path

    def reference(self):
        """The configuration's plain reference module."""
        if str(self.here) not in sys.path:
            sys.path.insert(0, str(self.here))
        return load_module(self.here / "reference" / f"{self.config['reference']}.py",
                           f"reference.{self.config['reference']}")

    def loop(self):
        return load_module(self.here / "loops" / f"{self.traffic['loop']}.py")

    def reader(self, metric: str):
        """``metrics/<metric>.py``, or where there is none, the reader of the
        name before its last dot, which serves every cell's copy of a metric
        (``mfu.cifar`` and ``mfu.chexpert`` both read ``metrics/mfu.py``)."""
        path = self.here / "metrics" / f"{metric}.py"
        if not path.exists() and "." in metric:
            path = self.here / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
        return load_module(path).read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` of the checkout's BENCHMARK.json with its files."""
    bench = read_json(root_of(here) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = read_json(root_of(here) / cfg_entry["file"])
    traffic = read_json(here / "traffic" / f"{w['traffic']}.json")
    limits = read_json(here / "limits" / f"{name}.json")
    return Cell(name, w, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], here)


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    thread: int
    meta: dict

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


class Record:
    """What a run leaves for the per-layer readers: host spans (kept only in
    traced runs), counters, and the device trace's summary."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.trace: Optional[dict] = None
        self.extra: dict = {}

    def span(self, name: str, start: float, end: float, thread: int = 0, **meta) -> None:
        if self.traced:
            self.spans.append(Span(name, start, end, thread, meta))

    def of(self, name: str, **match) -> List[Span]:
        return [s for s in self.spans if s.name == name
                and all(s.meta.get(k) == v for k, v in match.items())]


def now() -> float:
    return time.perf_counter()


def median(xs):
    return statistics.median(xs) if xs else None


def percentile(xs, q: float):
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    if not xs:
        return None
    xs = sorted(xs)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
