"""Share, in %, of the least time one PQ ``search_exact`` call could take,
in the device time of every kernel the call launches (copies excluded).

The least time is the larger of the scan's ``2 Q N D`` operations (each
query against every decoded row) at the bf16 dense peak and the bytes the
call needs at the memory rate: the codes once, the codebooks once, the
queries once, the rerank's ``Q k oversample`` f32 rows once and the
``Q k`` int32 ids and f32 distances once.  It counts the work whatever
implements it (decode, scan, survivor cut, rerank), so a later change that
fuses or removes a kernel keeps the same yardstick."""

from benchmark import peaks

#: bytes of one code, by the configuration's ``pq.codes``
CODE_BYTES = {"uint16": 2, "int32": 4}


def flops(q: int, n: int, d: int) -> float:
    return 2.0 * q * n * d


def nbytes(q: int, n: int, d: int, k: int, oversample: int, nsub: int, centroids: int,
           dsub: int, code_bytes: int) -> float:
    return (n * nsub * code_bytes + 4.0 * nsub * centroids * dsub + 4.0 * q * d
            + 4.0 * q * k * oversample * d + q * k * (4.0 + 4.0))


def least_seconds(q: int, n: int, d: int, k: int, oversample: int, nsub: int, centroids: int,
                  dsub: int, code_bytes: int) -> float:
    return max(flops(q, n, d) / peaks.BF16_FLOPS,
               nbytes(q, n, d, k, oversample, nsub, centroids, dsub, code_bytes) / peaks.HBM_BYTES_PER_S)


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0 or ctx.trace.kernel_s <= 0:
        return None
    cell = ctx.cell
    pq = cell.config["pq"]
    q, n, d = cell.traffic["batch"], cell.corpus.shape[0], cell.corpus.shape[1]
    least = least_seconds(q, n, d, cell.k, cell.traffic["oversample"], d // pq["dsub"],
                          pq["centroids"], pq["dsub"], CODE_BYTES[pq["codes"]])
    return 100.0 * least / (ctx.trace.kernel_s / ctx.trace.calls)
