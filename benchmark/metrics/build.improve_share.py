"""Share, in %, of the traced builds' wall time spent in the program's
``improve_index`` spans (``utils.trace.TRACER``; each ends in a host read of
the recall, so it waits for the card)."""


def read(ctx):
    build_s = sum((t1 - t0) * 1e-9 for t0, t1, name in ctx.cell.spans.spans if name == "build_call")
    improve = ctx.spans.get("improve_index")
    if build_s <= 0 or improve is None:
        return None
    return 100.0 * improve["seconds"] / build_s
