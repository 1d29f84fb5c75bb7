"""Share, in %, of the traced builds' wall time (the ``build_call`` spans)
that the host spent in hop loops: the sum of ``dispatch_s`` and ``wait_s``
over every ``search_layer`` span of the builds' searches."""

from benchmark.hop_loop import hop_loop_share


def read(ctx):
    return hop_loop_share(ctx)
