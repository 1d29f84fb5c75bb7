"""Mean hops of ``Hnsw.search_instrumented`` over the first 20 batches of
the cell's traffic, run after the window."""

BATCHES = 20


def read(ctx):
    return sum(ctx.driver.hops(i) for i in range(BATCHES)) / BATCHES
