"""Host microseconds a hop spends running the hop body, over the traced
window's ``search_layer`` spans: the sum of their ``dispatch_s`` over the sum
of their ``hops``."""

from benchmark.hop_loop import dispatch_us_per_hop


def read(ctx):
    return dispatch_us_per_hop(ctx)
