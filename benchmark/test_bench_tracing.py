"""The per-layer metrics that read the program's ``search_layer`` spans, on
synthetic events, and the program's span stamps laid against a device
trace as ``profiling.reduce`` does."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, profiling
from benchmark.test_bench_support import ROOT  # noqa: F401  (puts the checkout on the path)
from parallel_hnsw_tpu_torch.utils.trace import TRACER, PhaseEvent, Tracer

MS = 1_000_000


def _layer(hops, dispatch_s, wait_s, queries=100, layer=0):
    return PhaseEvent("search_layer", 1, dispatch_s + wait_s + 0.01, {
        "layer": layer, "queries": queries, "hops": hops, "dispatch_s": dispatch_s, "wait_s": wait_s})


#: two calls of two blocks (8,192 and 1,808 queries) over two layers, and a
#: span of another name, which no reader counts
EVENTS = [
    _layer(3, 0.003, 0.001, 8192, 0), _layer(120, 0.240, 0.060, 8192, 1),
    _layer(2, 0.002, 0.001, 1808, 0), _layer(75, 0.150, 0.040, 1808, 1),
    _layer(3, 0.003, 0.001, 8192, 0), _layer(118, 0.236, 0.059, 8192, 1),
    _layer(2, 0.002, 0.001, 1808, 0), _layer(77, 0.154, 0.041, 1808, 1),
    PhaseEvent("improve_index", 0, 5.0, {"hops": 1000}),
]
HOPS = 400
DISPATCH_S = 0.790
WAIT_S = 0.204


def _read(name, ctx):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(ctx)


def _ctx(calls=2, build_spans=()):
    spans = profiling.HostSpans()
    spans.spans = list(build_spans)
    return SimpleNamespace(cell=SimpleNamespace(spans=spans), driver=None,
                           trace=SimpleNamespace(calls=calls), spans={})


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(TRACER, "events", list(EVENTS))


@pytest.mark.parametrize("name", ["search.call_hops.qps", "search.call_hops.latency"])
def test_call_hops(events, name):
    assert _read(name, _ctx(calls=2)) == pytest.approx(HOPS / 2)
    assert _read(name, _ctx(calls=0)) is None


@pytest.mark.parametrize("name", ["search.dispatch_us_per_hop.qps", "search.dispatch_us_per_hop.latency",
                                  "search.dispatch_us_per_hop.build"])
def test_dispatch_us_per_hop(events, name):
    assert _read(name, _ctx()) == pytest.approx(1e6 * DISPATCH_S / HOPS)


def test_hop_loop_share(events):
    builds = [(0, 2000 * MS, "build_call"), (2500 * MS, 4500 * MS, "build_call"), (0, 9000 * MS, "other")]
    assert _read("build.hop_loop_share", _ctx(build_spans=builds)) == pytest.approx(
        100.0 * (DISPATCH_S + WAIT_S) / 4.0)
    assert _read("build.hop_loop_share", _ctx()) is None


@pytest.mark.parametrize("name", ["search.call_hops.qps", "search.call_hops.latency",
                                  "search.dispatch_us_per_hop.qps", "search.dispatch_us_per_hop.latency",
                                  "search.dispatch_us_per_hop.build", "build.hop_loop_share"])
def test_nothing_to_read_gives_none(monkeypatch, name):
    """A program that records no ``search_layer`` span with its counters (as
    before they were added) gives no reading, and raises nothing."""
    monkeypatch.setattr(TRACER, "events", [PhaseEvent("search_layer", 0, 1.0), EVENTS[-1]])
    assert _read(name, _ctx(build_spans=[(0, MS, "build_call")])) is None


@pytest.mark.parametrize("name", ["search.call_hops.qps", "search.dispatch_us_per_hop.build",
                                  "build.hop_loop_share"])
def test_no_device_trace_gives_none(events, name):
    """A traced run on the CPU has no device trace: nothing is read, as the
    benchmark's other traced metrics read nothing there."""
    ctx = _ctx(build_spans=[(0, MS, "build_call")])
    ctx.trace = None
    assert _read(name, ctx) is None


def test_program_spans_label_the_device_gaps():
    """The tracer's intervals, handed to ``reduce`` in a ``HostSpans``
    beside the benchmark's own, label an idle gap by the innermost program
    span: the stamps share the profiler's clock."""
    t = Tracer(enabled=True)
    call_t0 = time.time_ns()
    with t.span("search_layer"):
        time.sleep(0.002)
    call_t1 = time.time_ns()
    (l0, l1, _), = t.intervals()
    spans = profiling.HostSpans()
    spans.spans = [(call_t0, call_t1, "search_call")] + t.intervals()
    # device work at the call's two ends; the gap between them has its
    # middle inside the program's span
    events = [("k", call_t0, l0 - call_t0), ("k", l1, call_t1 - l1)]
    trace = profiling.reduce(events, call_t0, call_t1, spans, calls=1)
    gaps = dict(trace.gaps)
    assert list(gaps) == ["search_layer (1 gaps)"]
    assert gaps["search_layer (1 gaps)"] == pytest.approx((l1 - l0) * 1e-9)
