"""Share, in %, of the traced window's hops that were replayed from a CUDA
graph: the sum of the ``search_layer`` spans' ``graph_hops`` over the sum of
their ``hops``."""

from benchmark.graph_hops import graph_hop_share


def read(ctx):
    return graph_hop_share(ctx)
