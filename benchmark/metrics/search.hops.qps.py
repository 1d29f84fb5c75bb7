"""Hops of ``Hnsw.search_instrumented`` (the same ``search_stack`` that
``Hnsw.search`` runs) on the cell's batch, run after the window."""


def read(ctx):
    return float(ctx.driver.hops(0))
