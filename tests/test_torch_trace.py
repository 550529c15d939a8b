"""The port's spans (``chexpert_tpu_torch/utils/trace.py``) on the CPU.

Off, a train step keeps nothing and opens no range in a profiler's trace.
On, one step keeps ``step``, its three phases and one ``attn.fwd`` /
``attn.bwd`` per AA conv, all of one step id, each inside its parent: the
CIFAR bench's WideResNet-10-2 under the heads-in-lanes layout
(``HilAttention``) through ``cli.bench.train_step``, and aadensenet-tiny
under the head-major layout (``RelAttention``) through
``train.steps.train_step``. Under the profiler each span is a range of its
name around the ops it runs. A span opened on a thread with none open takes
the step's thread's innermost span as its parent, as the attention backward
does on the card, where autograd runs it on its own thread.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chexpert_tpu_torch.cli import bench
from chexpert_tpu_torch.models import AAConv2d, build_model, optimizer_spec
from chexpert_tpu_torch.train import TrainState, make_optimizer, train_step
from chexpert_tpu_torch.utils import trace

PHASES = ("step.forward", "step.backward", "step.optimizer")
NAMES = {trace.STEP, *PHASES, "attn.fwd", "attn.bwd", "input.augment", "input.to_device",
         "input.next"}
B = 2


@pytest.fixture
def tracer():
    """The tracer on for the test, off and empty after it."""
    trace.drain()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


def _bench_step(monkeypatch):
    """One call of the CIFAR bench's step on WideResNet-10-2 with AA convs
    (nh 2) in the hil layout; returns (run, number of AA convs)."""
    monkeypatch.setenv("CHEXPERT_ATTN_LAYOUT", "hil")
    args = bench.build_parser().parse_args(
        ["wideresnet", "10", "2", "--attn", "--attn_nh", "2", "--device", "cpu"])
    model, spec, kw = bench.build_bench_model(args, 10, 2)
    opt, sched, _ = make_optimizer(spec, model.parameters(), args.lr, **kw)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(bench.normalize(rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8))
                         .transpose(0, 3, 1, 2).copy())
    y = torch.from_numpy(rng.randint(0, 10, B))
    assert all(m.attn_layout == "hil" for m in model.modules() if isinstance(m, AAConv2d))
    return (lambda: bench.train_step(model, opt, sched, x, y, torch.float32),
            sum(isinstance(m, AAConv2d) for m in model.modules()))


def _chexpert_step(monkeypatch):
    """One call of the CheXpert train step on aadensenet-tiny, head-major
    layout (RelAttention)."""
    model = build_model("aadensenet-tiny", image_size=32, attn_impl="pallas")
    opt, sched, _ = make_optimizer(optimizer_spec("aadensenet121"), model.parameters(), 0.1)
    state = TrainState(model, opt, sched)
    rng = np.random.RandomState(1)
    batch = {"image": torch.from_numpy(rng.randn(B, 32, 32, 1).astype(np.float32)),
             "label": torch.from_numpy((rng.rand(B, 5) < 0.4).astype(np.float32)),
             "mask": torch.ones(B)}
    assert all(m.attn_layout == "bn" for m in model.modules() if isinstance(m, AAConv2d))
    return (lambda: train_step(state, batch, torch.float32),
            sum(isinstance(m, AAConv2d) for m in model.modules()))


STEPS = {"bench_hil": _bench_step, "chexpert_bn": _chexpert_step}


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _inside(e, r):
    return r["tid"] == e["tid"] and r["ts"] <= e["ts"] and \
        e["ts"] + e.get("dur", 0) <= r["ts"] + r["dur"]


def test_off_keeps_nothing_and_opens_no_range(monkeypatch, tmp_path):
    run, _ = _bench_step(monkeypatch)
    trace.drain()
    assert trace.span("a") is trace.span("b", x=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert trace.drain() == []
    names = {e["name"] for e in _events(prof, tmp_path)}
    assert "aten::convolution" in names and not names & NAMES


@pytest.mark.parametrize("which", sorted(STEPS))
def test_on_keeps_the_step_its_phases_and_each_attention(monkeypatch, tracer, which):
    run, n_aa = STEPS[which](monkeypatch)
    assert n_aa > 0
    run()
    spans = tracer.drain()
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert sorted(names) == sorted([trace.STEP, *PHASES] + ["attn.fwd", "attn.bwd"] * n_aa)
    assert not any(n.startswith("bench.") for n in names)
    (step,) = [s for s in spans if s.name == trace.STEP]
    assert step.parent is None and {s.step for s in spans} == {step.id}
    phase = {s.name: s for s in spans if s.name in PHASES}
    assert all(p.parent == step.id for p in phase.values())
    assert phase["step.forward"].end <= phase["step.backward"].start
    assert phase["step.backward"].end <= phase["step.optimizer"].start
    for s in spans:
        if s.name == "attn.fwd":
            assert s.parent == phase["step.forward"].id
        if s.name == "attn.bwd":
            assert s.parent == phase["step.backward"].id
        if s.name.startswith("attn."):
            assert s.meta["H"] in (16, 8, 4, 2) and s.meta["W"] == s.meta["H"]
            assert s.meta.get("heads", 0) > 0 or s.meta.get("batch_heads", 0) > 0
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end, (s, p)
    assert {s.meta["H"] for s in spans if s.name == "attn.fwd"} == \
        {s.meta["H"] for s in spans if s.name == "attn.bwd"}


def test_each_span_is_a_range_around_its_ops(monkeypatch, tmp_path, tracer):
    run, _ = _bench_step(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = tracer.drain()
    events = _events(prof, tmp_path)
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in NAMES:
            ranges.setdefault(e["name"], []).append(e)
    assert sorted(ranges) == sorted({s.name for s in spans})
    for name, rs in ranges.items():
        kept = sorted((s for s in spans if s.name == name), key=lambda s: s.start)
        rs.sort(key=lambda e: e["ts"])
        assert len(rs) == len(kept), name
        for s, r in zip(kept, rs):  # the span lies inside its range
            assert (s.end - s.start) * 1e6 <= r["dur"] + 1.0, name
            assert any(e.get("cat") == "cpu_op" and _inside(e, r) for e in events), name

    def within(op, name):
        hits = [e for e in events if e["name"] == op]
        assert hits, op
        return all(any(_inside(e, r) for r in ranges[name]) for e in hits)

    assert within("aten::convolution", "step.forward")
    assert within("aten::convolution_backward", "step.backward")
    assert within("aten::logsumexp", "attn.fwd")  # the plain B5's softmax
    opt = [e["name"] for e in events if e["name"].startswith("Optimizer.step#")]
    assert opt and within(opt[0], "step.optimizer")


def test_input_spans(tracer):
    rng = np.random.RandomState(0)
    x = bench.augment(rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8), rng)
    bench.to_device(x, torch.device("cpu"))
    spans = tracer.drain()
    assert [s.name for s in spans] == ["input.augment", "input.to_device"]
    assert all(s.parent is None and s.step is None and s.end >= s.start for s in spans)
    assert spans[1].meta == {"bytes": x.nbytes, "dtype": "uint8"}  # what the copy moved


def test_a_span_on_another_thread_finds_the_step(tracer):
    """Autograd's device thread opens ``attn.bwd`` with nothing open on it:
    its parent is the step's open phase; outside a step it has none."""
    def other():
        with trace.span("attn.bwd"):
            pass

    with trace.span(trace.STEP):
        with trace.span("step.backward"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    inner, phase, step, outer_bwd = tracer.drain()
    assert (inner.name, phase.name, step.name) == ("attn.bwd", "step.backward", trace.STEP)
    assert inner.thread != phase.thread == step.thread
    assert (inner.parent, inner.step) == (phase.id, step.id)
    assert (phase.parent, phase.step, step.parent) == (step.id, step.id, None)
    assert (outer_bwd.parent, outer_bwd.step) == (None, None)


def test_spans_open_when_disabled_close_and_are_kept(tracer):
    with trace.span("input.next", k=1):
        trace.disable()
        with trace.span("step"):
            pass
    (s,) = trace.drain()
    assert s.name == "input.next" and s.meta == {"k": 1}
