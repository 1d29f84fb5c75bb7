"""Share, in %, of the traced window's hops whose queue update ran the
queue-merge kernel: the sum of the ``search_layer`` spans'
``merge_kernel_hops`` over the sum of their ``hops``."""

from benchmark.merge_kernel import merge_kernel_share


def read(ctx):
    return merge_kernel_share(ctx)
