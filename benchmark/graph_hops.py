"""The share of the hop loop's hops that were replayed from a CUDA graph,
read from the program's ``search_layer`` spans (their closing counters
``hops`` and ``graph_hops``).

A program that records no ``graph_hops`` (one without graphs) gives no
reading, nor does a run with no device trace, as with the other readers of
these spans (``benchmark/hop_loop.py``).
"""

from __future__ import annotations

from typing import Optional

from benchmark.hop_loop import layer_events


def graph_hop_share(ctx) -> Optional[float]:
    """100 x the replayed hops over all hops, over the traced window's
    layer searches."""
    events = [e for e in layer_events(ctx) if "graph_hops" in e.counters]
    hops = sum(float(e.counters["hops"]) for e in events)
    if hops == 0:
        return None
    return 100.0 * sum(float(e.counters["graph_hops"]) for e in events) / hops
