"""The reduction of a device trace to busy time, kernel time, operations
and labelled idle gaps, on synthetic events."""

from __future__ import annotations

import pytest
import torch

from benchmark import profiling

MS = 1_000_000


def _spans() -> profiling.HostSpans:
    spans = profiling.HostSpans()
    spans.spans = [(0, 60 * MS, "search_call"), (60 * MS, 80 * MS, "ids_to_host")]
    return spans


def test_busy_idle_and_gaps():
    events = [
        ("scan", 10 * MS, 20 * MS),        # [10, 30]
        ("sort", 20 * MS, 20 * MS),        # [20, 40]: overlaps the scan
        ("Memcpy DtoH", 70 * MS, 5 * MS),  # [70, 75]: a copy, not a kernel
    ]
    trace = profiling.reduce(events, 0, 100 * MS, _spans(), calls=2)
    assert trace.window_s == pytest.approx(0.1)
    assert trace.busy_s == pytest.approx(0.035)
    assert trace.kernel_s == pytest.approx(0.040)
    assert trace.idle_share == pytest.approx(65.0)
    ops = dict(trace.ops)
    assert ops["scan"] == ops["sort"] == pytest.approx(0.02)
    assert ops["Memcpy DtoH"] == pytest.approx(0.005)
    gaps = dict(trace.gaps)
    # [0, 10] and [40, 70] (middle 55) in search_call, [75, 100] (middle 87.5) outside
    assert gaps["search_call (2 gaps)"] == pytest.approx(0.04)
    assert gaps[f"{profiling.OUTSIDE} (1 gaps)"] == pytest.approx(0.025)


def test_events_past_the_window_are_cut():
    trace = profiling.reduce([("k", -5 * MS, 10 * MS), ("k", 95 * MS, 10 * MS)], 0, 100 * MS,
                             _spans(), calls=1)
    assert trace.busy_s == pytest.approx(0.010)


def test_spans_record_only_while_enabled():
    spans = profiling.HostSpans()
    with spans.span("search_call"):
        pass
    assert spans.spans == []
    spans.enabled = True
    with spans.span("search_call"):
        with spans.span("ids_to_host"):
            pass
    inner = spans.spans[0]
    assert spans.label((inner[0] + inner[1]) / 2) == "ids_to_host"


class _Event:
    def __init__(self, name, start, dur, device):
        self._name, self._start, self._dur, self._device = name, start, dur, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device


def test_traced_reduces_the_profilers_device_events(monkeypatch):
    """``traced`` hands the profiler's device events, and only those, to
    ``reduce``: host events and empty events are left out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    seen = {}

    class _Profile:
        def __init__(self, activities):
            self.profiler = self

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        @property
        def kineto_results(self):
            return self

        def events(self):
            t0 = seen["t0"]
            return [
                _Event("scan", t0 + 1 * MS, 2 * MS, cuda),
                _Event("host_op", t0, 50 * MS, cpu),
                _Event("empty", t0 + 5 * MS, 0, cuda),
            ]

    clock = iter(range(0, 10**12, 10 * MS))

    def fake_ns():
        value = next(clock)
        seen.setdefault("t0", value)
        return value

    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling.torch.profiler, "profile", _Profile)
    monkeypatch.setattr(profiling.time, "time_ns", fake_ns)
    spans = profiling.HostSpans()
    trace = profiling.traced(lambda: 3, spans)
    assert trace.calls == 3
    assert spans.enabled is False
    assert [name for name, _ in trace.ops] == ["scan"]
    assert trace.busy_s == pytest.approx(0.002)
    assert trace.window_s == pytest.approx(0.010)
