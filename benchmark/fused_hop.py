"""The share of the hop loop's hops that ran as the two hop launches (the
expand kernel, then the queue merge with the termination accounting), read
from the program's ``search_layer`` spans (their closing counters ``hops``
and ``fused_hops``).

A program that records no ``fused_hops`` (one whose hop is torch operations
around its kernels) gives no reading, nor does a run with no device trace,
as with the other readers of these spans (``benchmark/merge_kernel.py``).
"""

from __future__ import annotations

from typing import Optional

from benchmark.hop_loop import layer_events


def fused_hop_share(ctx) -> Optional[float]:
    """100 x the hops that ran the expand kernel over all hops, over the
    traced window's layer searches."""
    events = [e for e in layer_events(ctx) if "fused_hops" in e.counters]
    hops = sum(float(e.counters["hops"]) for e in events)
    if hops == 0:
        return None
    return 100.0 * sum(float(e.counters["fused_hops"]) for e in events) / hops
