"""The share of the hop loop's hops whose queue update ran the queue-merge
kernel, read from the program's ``search_layer`` spans (their closing
counters ``hops`` and ``merge_kernel_hops``).

A program that records no ``merge_kernel_hops`` (one without the kernel)
gives no reading, nor does a run with no device trace, as with the other
readers of these spans (``benchmark/hop_loop.py``, ``benchmark/graph_hops.py``).
"""

from __future__ import annotations

from typing import Optional

from benchmark.hop_loop import layer_events


def merge_kernel_share(ctx) -> Optional[float]:
    """100 x the hops that ran the kernel over all hops, over the traced
    window's layer searches."""
    events = [e for e in layer_events(ctx) if "merge_kernel_hops" in e.counters]
    hops = sum(float(e.counters["hops"]) for e in events)
    if hops == 0:
        return None
    return 100.0 * sum(float(e.counters["merge_kernel_hops"]) for e in events) / hops
