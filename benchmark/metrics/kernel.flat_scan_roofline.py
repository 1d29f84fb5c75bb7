"""Share, in %, of the least time one ``fast_flat_knn`` call could take, in
the device time of every kernel the call launches.

The least time is the larger of the scan's ``2 Q N D`` operations at the
bf16 dense peak and the bytes the call needs (the f32 corpus once, the
queries once, ``Q k`` int32 ids and f32 distances once) at the memory rate.
It counts the work whatever implements the scan, so a later change that
fuses or removes a kernel keeps the same yardstick."""

from benchmark import peaks


def flops(q: int, n: int, d: int) -> float:
    return 2.0 * q * n * d


def nbytes(q: int, n: int, d: int, k: int) -> float:
    return 4.0 * n * d + 4.0 * q * d + q * k * (4.0 + 4.0)


def least_seconds(q: int, n: int, d: int, k: int) -> float:
    return max(flops(q, n, d) / peaks.BF16_FLOPS, nbytes(q, n, d, k) / peaks.HBM_BYTES_PER_S)


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0 or ctx.trace.kernel_s <= 0:
        return None
    cell = ctx.cell
    q, n, d = cell.traffic["batch"], cell.corpus.shape[0], cell.corpus.shape[1]
    per_call = ctx.trace.kernel_s / ctx.trace.calls
    return 100.0 * least_seconds(q, n, d, cell.k) / per_call
