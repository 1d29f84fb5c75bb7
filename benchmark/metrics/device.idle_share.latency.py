"""Share, in %, of the traced window in which no kernel or copy ran on the
device (``torch.profiler``, device activity)."""

from benchmark.profiling import idle_share


def read(ctx):
    return idle_share(ctx.trace)
