"""Times each code was decoded a call: the decoded rows of the traced
window's ``pq_scan`` spans (``QuantizedHnsw.search_exact``, one per query
block), over the corpus's rows times the window's calls.  The scan decodes
every code once for each query block, so a call of 10,000 queries in blocks
of 4,096 reads 3."""

from parallel_hnsw_tpu_torch.utils.trace import TRACER


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    decoded = sum(float(e.counters["decoded_rows"]) for e in TRACER.events
                  if e.name == "pq_scan" and "decoded_rows" in e.counters)
    if decoded == 0:
        return None
    return decoded / (ctx.cell.corpus.shape[0] * ctx.trace.calls)
