"""The per-layer metrics that read the share of hops whose queue update ran
the queue-merge kernel from the program's ``search_layer`` spans, on
synthetic events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.test_bench_support import ROOT  # noqa: F401  (puts the checkout on the path)
from parallel_hnsw_tpu_torch.utils.trace import TRACER, PhaseEvent

NAMES = ["search.merge_kernel_share.latency", "search.merge_kernel_share.qps",
         "search.merge_kernel_share.build"]


def _layer(hops, merge_kernel_hops=None):
    counters = {"layer": 0, "queries": 100, "hops": hops, "dispatch_s": 0.01, "wait_s": 0.01,
                "graph_hops": 0, "captures": 0}
    if merge_kernel_hops is not None:
        counters["merge_kernel_hops"] = merge_kernel_hops
    return PhaseEvent("search_layer", 1, 0.03, counters)


def _read(name, trace=True):
    ctx = SimpleNamespace(cell=None, driver=None, spans={},
                          trace=SimpleNamespace(calls=2) if trace else None)
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(ctx)


@pytest.mark.parametrize("name", NAMES)
def test_every_hop_through_the_kernel_reads_100(monkeypatch, name):
    events = [_layer(3, 3), _layer(120, 120), _layer(4, 4), _layer(118, 118),
              PhaseEvent("improve_index", 0, 5.0, {"hops": 1000, "merge_kernel_hops": 0})]
    monkeypatch.setattr(TRACER, "events", events)
    assert _read(name) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NAMES)
def test_share_of_kernel_hops(monkeypatch, name):
    # a layer search on the CPU among layer searches on the card
    monkeypatch.setattr(TRACER, "events", [_layer(3, 3), _layer(120, 0), _layer(118, 118)])
    assert _read(name) == pytest.approx(100.0 * 121 / 241)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_none(monkeypatch, name):
    """A program whose spans carry no ``merge_kernel_hops`` (one without the
    kernel), a window without layer searches or hops, and a run with no
    device trace give no reading, and raise nothing."""
    monkeypatch.setattr(TRACER, "events", [_layer(120), _layer(3)])
    assert _read(name) is None
    monkeypatch.setattr(TRACER, "events", [_layer(0, 0)])
    assert _read(name) is None
    monkeypatch.setattr(TRACER, "events", [])
    assert _read(name) is None
    monkeypatch.setattr(TRACER, "events", [_layer(120, 120)])
    assert _read(name) == pytest.approx(100.0)
    assert _read(name, trace=False) is None
