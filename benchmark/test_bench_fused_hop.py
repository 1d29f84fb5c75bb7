"""The per-layer metrics that read the share of hops that ran as the two
hop launches from the program's ``search_layer`` spans, on synthetic
events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.test_bench_support import ROOT  # noqa: F401  (puts the checkout on the path)
from parallel_hnsw_tpu_torch.utils.trace import TRACER, PhaseEvent

NAMES = ["search.fused_hop_share.latency", "search.fused_hop_share.qps",
         "search.fused_hop_share.build"]


def _layer(hops, fused_hops=None):
    counters = {"layer": 0, "queries": 100, "hops": hops, "dispatch_s": 0.01, "wait_s": 0.01,
                "graph_hops": 0, "captures": 0, "merge_kernel_hops": hops}
    if fused_hops is not None:
        counters["fused_hops"] = fused_hops
    return PhaseEvent("search_layer", 1, 0.03, counters)


def _read(name, trace=True):
    ctx = SimpleNamespace(cell=None, driver=None, spans={},
                          trace=SimpleNamespace(calls=2) if trace else None)
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(ctx)


@pytest.mark.parametrize("name", NAMES)
def test_every_hop_in_two_launches_reads_100(monkeypatch, name):
    events = [_layer(3, 3), _layer(120, 120), _layer(4, 4), _layer(118, 118),
              PhaseEvent("improve_index", 0, 5.0, {"hops": 1000, "fused_hops": 0})]
    monkeypatch.setattr(TRACER, "events", events)
    assert _read(name) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NAMES)
def test_share_of_fused_hops(monkeypatch, name):
    # a memmap source's layer search (the torch hop) among dense ones
    monkeypatch.setattr(TRACER, "events", [_layer(3, 3), _layer(120, 0), _layer(118, 118)])
    assert _read(name) == pytest.approx(100.0 * 121 / 241)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_none(monkeypatch, name):
    """A program whose spans carry no ``fused_hops`` (the parent of the two
    launches), a window without layer searches or hops, and a run with no
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
