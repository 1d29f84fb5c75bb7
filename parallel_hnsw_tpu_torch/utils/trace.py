"""Structured tracing: per-phase timers + a ``torch.profiler`` hook
(counterpart of ``parallel_hnsw_tpu.utils.trace``).

* A phase's wall time only means something if the device work launched inside
  it has retired; CUDA launches are asynchronous.  ``span(..., sync=x)``
  synchronizes the device of any CUDA tensor in ``x`` before closing the
  timer.
* Spans are stamped with ``time.time_ns()``, the clock ``torch.profiler``
  stamps its device events with, so a span can be laid against a device
  trace (:meth:`Tracer.intervals`).
* Tracing is zero-cost when disabled: the global tracer defaults to disabled
  and ``span`` short-circuits.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Tuple

import torch


@dataclass
class PhaseEvent:
    """One completed phase: name, nesting depth, wall seconds, counters, and
    its start and end in ``time.time_ns()`` nanoseconds (a counter event
    starts and ends at once)."""

    name: str
    depth: int
    seconds: float
    counters: Dict[str, float] = field(default_factory=dict)
    t0_ns: int = 0
    t1_ns: int = 0


def _sync(x: Any) -> None:
    """Wait for the device work behind any CUDA tensor in ``x`` (a tensor or
    a nested tuple/list/dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for leaf in x:
            _sync(leaf)
    elif isinstance(x, dict):
        for leaf in x.values():
            _sync(leaf)


class Tracer:
    """Collects nested phase timings as structured events.

    >>> t = Tracer(enabled=True)
    >>> with t.span("build"):
    ...     with t.span("layer0", n_nodes=100) as closing:
    ...         closing["hops"] = 7
    >>> t.events[0].name, t.events[1].name, t.events[0].counters
    ('layer0', 'build', {'n_nodes': 100, 'hops': 7})
    """

    def __init__(self, enabled: bool = False, log=None):
        self.enabled = enabled
        self.log = log
        self.events: List[PhaseEvent] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, sync: Any = None, **counters: float) -> Iterator[Dict[str, float]]:
        """Time the block as one event with ``counters``.  The block is handed
        a dict for the counters known only when it ends (hops, rows changed);
        they are recorded with the others.  Disabled, the dict is dropped."""
        if not self.enabled:
            yield {}
            return
        closing: Dict[str, float] = {}
        self._depth += 1
        t0 = time.time_ns()
        try:
            yield closing
        finally:
            if sync is not None:
                _sync(sync)
            t1 = time.time_ns()
            dt = (t1 - t0) * 1e-9
            self._depth -= 1
            ev = PhaseEvent(name, self._depth, dt, {**counters, **closing}, t0, t1)
            self.events.append(ev)
            if self.log is not None:
                pad = "  " * ev.depth
                extra = "".join(f" {k}={v}" for k, v in ev.counters.items())
                self.log(f"[trace] {pad}{name}: {dt*1e3:.1f}ms{extra}")

    def count(self, name: str, **counters: float) -> None:
        """Record an instantaneous counter event (zero duration)."""
        if self.enabled:
            now = time.time_ns()
            self.events.append(PhaseEvent(name, self._depth, 0.0, dict(counters), now, now))

    def intervals(self) -> List[Tuple[int, int, str]]:
        """Every event as ``(t0_ns, t1_ns, name)``, the form of the
        benchmark's host spans, so an idle gap in a device trace can be
        labelled by the program's span around it."""
        return [(ev.t0_ns, ev.t1_ns, ev.name) for ev in self.events]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregate totals per phase name: total seconds + call count."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            row = out.setdefault(ev.name, {"seconds": 0.0, "calls": 0.0})
            row["seconds"] += ev.seconds
            row["calls"] += 1.0
        return out

    def format_summary(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["seconds"])
        lines = [f"{'phase':<32} {'calls':>6} {'total_s':>9}"]
        for name, row in rows:
            lines.append(f"{name:<32} {int(row['calls']):>6} {row['seconds']:>9.2f}")
        return "\n".join(lines)


#: Global tracer; disabled (zero-cost) unless a caller enables it.
TRACER = Tracer(enabled=False)


def enable_tracing(log=print) -> Tracer:
    """Turn on the global tracer (optionally routing events to ``log``)."""
    TRACER.enabled = True
    TRACER.log = log
    return TRACER


@contextlib.contextmanager
def torch_profile(logdir: str) -> Iterator[torch.profiler.profile]:
    """On-demand ``torch.profiler`` capture (host and, where a card is
    present, CUDA activity) around a code region; writes a Chrome trace to
    ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
