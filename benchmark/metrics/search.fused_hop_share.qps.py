"""Share, in %, of the traced window's hops that ran as the two hop
launches: the sum of the ``search_layer`` spans' ``fused_hops`` over the sum
of their ``hops``."""

from benchmark.fused_hop import fused_hop_share


def read(ctx):
    return fused_hop_share(ctx)
