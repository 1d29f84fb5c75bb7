"""Hops of the traced window's ``Hnsw.search`` calls, counted where they run:
the ``hops`` of every ``search_layer`` span (one per layer and query block),
summed and divided by the window's calls."""

from benchmark.hop_loop import call_hops


def read(ctx):
    return call_hops(ctx)
