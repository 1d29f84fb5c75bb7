"""The per-layer metrics that read the share of replayed hops from the
program's ``search_layer`` spans, on synthetic events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.test_bench_support import ROOT  # noqa: F401  (puts the checkout on the path)
from parallel_hnsw_tpu_torch.utils.trace import TRACER, PhaseEvent

NAMES = ["search.graph_hop_share.latency", "search.graph_hop_share.qps",
         "search.graph_hop_share.build"]


def _layer(hops, graph_hops=None, captures=0):
    counters = {"layer": 0, "queries": 100, "hops": hops, "dispatch_s": 0.01, "wait_s": 0.01}
    if graph_hops is not None:
        counters.update(graph_hops=graph_hops, captures=captures)
    return PhaseEvent("search_layer", 1, 0.03, counters)


def _read(name, trace=True):
    ctx = SimpleNamespace(cell=None, driver=None, spans={},
                          trace=SimpleNamespace(calls=2) if trace else None)
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(ctx)


@pytest.mark.parametrize("name", NAMES)
def test_share_of_replayed_hops(monkeypatch, name):
    # upper layers eager, bottom layers replayed (one captured in the window)
    events = [_layer(3, 0), _layer(120, 112, 1), _layer(4, 0), _layer(118, 118),
              PhaseEvent("improve_index", 0, 5.0, {"hops": 1000, "graph_hops": 0})]
    monkeypatch.setattr(TRACER, "events", events)
    assert _read(name) == pytest.approx(100.0 * 230 / 245)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_none(monkeypatch, name):
    """A program whose spans carry no ``graph_hops`` (one without graphs),
    a window without layer searches or hops, and a run with no device
    trace give no reading, and raise nothing."""
    monkeypatch.setattr(TRACER, "events", [_layer(120), _layer(3)])
    assert _read(name) is None
    monkeypatch.setattr(TRACER, "events", [_layer(0, 0)])
    assert _read(name) is None
    monkeypatch.setattr(TRACER, "events", [])
    assert _read(name) is None
    monkeypatch.setattr(TRACER, "events", [_layer(120, 120, 1)])
    assert _read(name) == pytest.approx(100.0)
    assert _read(name, trace=False) is None
