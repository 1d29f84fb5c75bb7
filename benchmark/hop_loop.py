"""The program's ``search_layer`` spans (``utils.trace.TRACER``), read by the
per-layer metrics of the hop loop.

Each layer search of ``search.search_stack`` (and of the adaptive path) is
one span, per query block, with the closing counters ``hops``,
``dispatch_s`` (host seconds in the hop bodies) and ``wait_s`` (host seconds
in the termination reads).  A program that records no such span gives no
events, and every reading here is then ``None``; so is a run with no device
trace (on the CPU), like the benchmark's other traced readings.
"""

from __future__ import annotations

from typing import List, Optional

from parallel_hnsw_tpu_torch.utils.trace import TRACER


def layer_events(ctx) -> List:
    """The traced window's ``search_layer`` events that carry their counters."""
    if ctx.trace is None:
        return []
    return [e for e in TRACER.events if e.name == "search_layer" and "hops" in e.counters]


def _sum(events: List, key: str) -> float:
    return sum(float(e.counters[key]) for e in events)


def call_hops(ctx) -> Optional[float]:
    """Hops of every layer search of every block, over the window's calls."""
    events = layer_events(ctx)
    if not events or ctx.trace.calls == 0:
        return None
    return _sum(events, "hops") / ctx.trace.calls


def dispatch_us_per_hop(ctx) -> Optional[float]:
    """Host microseconds spent running the hop bodies, a hop."""
    events = layer_events(ctx)
    hops = _sum(events, "hops")
    if hops == 0:
        return None
    return 1e6 * _sum(events, "dispatch_s") / hops


def hop_loop_share(ctx) -> Optional[float]:
    """Share, in %, of the builds' wall time (the ``build_call`` spans) that
    the host spent in the hop loops: their bodies and termination reads."""
    events = layer_events(ctx)
    build_s = sum((t1 - t0) * 1e-9 for t0, t1, name in ctx.cell.spans.spans if name == "build_call")
    if not events or build_s <= 0:
        return None
    return 100.0 * (_sum(events, "dispatch_s") + _sum(events, "wait_s")) / build_s
