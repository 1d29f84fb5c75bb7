"""Share, in %, of the traced calls' wall time (the ``scan_call`` spans) in
the program's ``pq_rerank`` spans (``QuantizedHnsw._rerank``, the exact
float32 rerank of the survivors; each waits for the card)."""


def read(ctx):
    call_s = sum((t1 - t0) * 1e-9 for t0, t1, name in ctx.cell.spans.spans if name == "scan_call")
    rerank = ctx.spans.get("pq_rerank")
    if call_s <= 0 or rerank is None:
        return None
    return 100.0 * rerank["seconds"] / call_s
