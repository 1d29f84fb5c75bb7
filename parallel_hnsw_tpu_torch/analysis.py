"""Brute-force top-k, the fast flat scan and recall measurement
(counterpart of the main-path and flat-scan parts of
``parallel_hnsw_tpu.analysis``).

:func:`blocked_topk_pairwise` is where the main path reaches the
pairwise-distance kernel: exact build seeds, the exact and fast relink tiers
and :func:`brute_force_knn` all run through it.  :func:`fast_flat_knn` is
where the flat-scan path reaches the binned and folded scan kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE, MATRIX_BYTE_BUDGET
from parallel_hnsw_tpu_torch.graph import (
    DenseSource,
    Layer,
    Source,
    gather_features,
    materialize_source,
    source_get,
)
from parallel_hnsw_tpu_torch.ops.cuda_distance import best_pairwise_distance, prepare_operand
from parallel_hnsw_tpu_torch.ops.cuda_scan import LANES, binned_scan, folded_scan, scan_operand
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance
from parallel_hnsw_tpu_torch.ops.queues import sort_queue
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.search import search

def brute_force_knn(
    source: Source, queries: torch.Tensor, metric: Metric, k: int, query_block: int = 4096
):
    """Exact top-k by full pairwise distances. Returns (ids, dists)."""
    vecs = materialize_source(source)
    return blocked_topk_pairwise(queries, vecs, metric, k, row_block=query_block)


def select_scan_mode(n: int) -> str:
    """Scan-engine frontier for ``fast_flat_knn(scan_mode="auto")``:
    exhaustive below 200k rows (cheap, exact-id parity), the binned kernel in
    [200k, 2M), the folded kernel at >= 2M.

    The cut-offs are the JAX package's, found on a TPU; PERF.md holds the
    three modes' times on the H100 for a later reset."""
    if n >= 2_000_000:
        return "folded"
    if n >= 200_000:
        return "binned"
    return "exhaustive"


FLAT_TILE_C = 4096


def flat_corpus_block(
    n: int,
    mode: str,
    fused: bool,
    query_block: int = 4096,
    corpus_block: int = 1 << 19,
    tile_c: int = FLAT_TILE_C,
    dense: bool = True,
) -> int:
    """Rows of the corpus that one scan block of :func:`fast_flat_knn` covers.

    The block is cut so the matrix that reaches device memory stays within
    ``MATRIX_BYTE_BUDGET``.  With ``fused`` (CUDA operands: the kernels write
    only the REDUCED ``[query_block, rows / (tile_c / 128)]`` bin matrix and
    never the distances) a binned block is ``tile_c / 128`` times wider; the
    plain versions materialize ``[query_block, rows]``, so on the CPU the
    unreduced bound stays.  A folded scan's output does not grow with the
    corpus: a ``dense`` corpus is one block, streamed by the kernel; a source
    that is reconstructed block by block (PQ) keeps the reduced bound, as in
    the JAX package."""
    reduction = tile_c // LANES
    budget_cols = MATRIX_BYTE_BUDGET // (query_block * 4)
    if mode == "folded":
        if dense:
            return n
        return max(tile_c, min(corpus_block * reduction, budget_cols * reduction))
    if mode == "binned" and fused:
        return max(tile_c, min(corpus_block * reduction, budget_cols * reduction))
    return max(tile_c if mode == "binned" else 4096, min(corpus_block, budget_cols))


def _cut_survivors(bin_d, bin_cols, offset: int, kk: int):
    """The ``kk`` smallest entries of ``bin_d`` as ``(ids, dists)`` sorted by
    ``(dist, id)``.  ``bin_cols`` maps a bin to its corpus column (``None``:
    the entries are the columns themselves); padding bins (``+inf``) become
    ``EMPTY_ID`` so the rerank excludes them (their gathers would otherwise
    clip to real rows)."""
    dd, pos = torch.topk(bin_d, min(kk, bin_d.shape[-1]), dim=-1, largest=False)
    ids = (pos if bin_cols is None else torch.gather(bin_cols, -1, pos)) + offset
    ids = torch.where(torch.isfinite(dd), ids, EMPTY_ID).to(ID_DTYPE)
    return sort_queue(ids, dd)


def _rerank(source: Source, q: torch.Tensor, cand: torch.Tensor, metric: Metric, k: int):
    """Full-precision distances of each query's survivors ``cand [rows, kk]``,
    sorted by ``(dist, id)`` and cut to ``k``."""
    d = batched_distance(q, source_get(source, cand), metric)
    d = torch.where(cand == EMPTY_ID, EMPTY_DIST, d)
    r_i, r_d = sort_queue(cand, d)
    return r_i[:, :k], r_d[:, :k]


def fast_flat_knn(
    source: Source,
    queries: torch.Tensor,
    metric: Metric,
    k: int,
    oversample: int = 4,
    query_block: int = 4096,
    corpus_block: int = 1 << 19,
    scan_mode: str = "auto",
):
    """Top-k by fast-precision flat scan + exact rerank. Returns (ids, dists).

    The speed engine for dense corpora: a scan that keeps ``oversample * k``
    survivors per query and a full-precision rerank of them.  Below 200k
    rows the scan is exhaustive per block (the pairwise-distance kernel's
    fast mode: bf16 dots on the card, fp32 on the CPU, where its recall
    equals the exact scan's).  At or above that it switches to the
    fused binned-scan kernel (``ops.cuda_scan``) on bf16 operands: each
    distance tile reduces to per-congruence-class minima inside the kernel,
    so the ``[Q, C]`` matrix never reaches device memory.  A true neighbor is
    lost only when a closer row shares its tile and class; raise
    ``oversample`` to push recall toward 1.

    ``scan_mode``: "auto" follows :func:`select_scan_mode`; or force
    "exhaustive" / "binned" / "folded".  "folded" folds the cross-tile
    minimum inside the kernel too: the top-k input is a fixed
    ``[Q, n_slots * 128]`` slab and the whole corpus is one scan block.

    The JAX package cuts survivors with ``approx_min_k``; here it is an
    exact ``torch.topk`` re-sorted by ``(dist, id)``, which can only raise
    recall."""
    metric = Metric(metric)
    tile_c = FLAT_TILE_C
    k_scan = max(k, k * oversample)
    n = source.count
    mode = select_scan_mode(n) if scan_mode == "auto" else scan_mode
    if mode not in ("exhaustive", "binned", "folded"):
        raise ValueError(f"unknown scan_mode {scan_mode!r}")
    # a source that is not one dense tensor is gathered block by block: a
    # PqSource reconstructed on its device, a MemmapSource gathered on the
    # host and copied to the queries' device (the corpus never is, whole)
    dense = isinstance(source, DenseSource)
    corpus_block = flat_corpus_block(
        n, mode, queries.is_cuda, query_block, corpus_block, tile_c, dense=dense
    )
    queries = queries.contiguous()
    # the fast kernels take bf16 copies of their operands: a dense corpus's
    # is made once, a reconstructed source's once per block it is rebuilt
    exhaustive = mode == "exhaustive"

    def operand(m):
        m = m.contiguous()
        return prepare_operand(m, metric, exact=False) if exhaustive else scan_operand(m)

    if dense:
        vectors = operand(source.vectors)
    else:
        all_ids = torch.arange(n, dtype=ID_DTYPE, device=queries.device)
    out_i, out_d = [], []
    for qs in range(0, queries.shape[0], query_block):
        q = queries[qs : qs + query_block]
        q = prepare_operand(q, metric, exact=False) if exhaustive else scan_operand(q)
        best_i = best_d = None
        for cs in range(0, n, corpus_block):
            kk = min(k_scan, n - cs, corpus_block)
            if not dense:
                vecs = operand(gather_features(source, all_ids[cs : cs + corpus_block]))
            elif exhaustive:
                vecs = vectors.narrow(cs, cs + corpus_block)
            else:
                vecs = vectors[cs : cs + corpus_block]
            if mode == "folded":
                bd, bc = folded_scan(q, vecs, metric, tile_c=tile_c, exact=False)
            elif mode == "binned":
                bd, bc = binned_scan(q, vecs, metric, tile_c=tile_c, exact=False)
            else:
                bd, bc = best_pairwise_distance(q, vecs, metric, exact=False), None
            idx, dd = _cut_survivors(bd, bc, cs, kk)
            if best_i is None:
                best_i, best_d = idx, dd
            else:
                s_i, s_d = sort_queue(torch.cat([best_i, idx], -1), torch.cat([best_d, dd], -1))
                best_i, best_d = s_i[:, :k_scan], s_d[:, :k_scan]
        # bound the [rows, k_scan, D] rerank gather to the byte budget
        q = queries[qs : qs + query_block]
        rb = max(64, MATRIX_BYTE_BUDGET // max(1, k_scan * source.dim * 4))
        for rs in range(0, q.shape[0], rb):
            r_i, r_d = _rerank(source, q[rs : rs + rb], best_i[rs : rs + rb], metric, k)
            out_i.append(r_i)
            out_d.append(r_d)
    return torch.cat(out_i), torch.cat(out_d)


def first_hit_recall(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    sp: SearchParams,
    query_block: int = 0,
) -> float:
    """Fraction of corpus vectors that retrieve themselves as the top result
    (reference: do_test_recall, src/lib.rs:2166-2192)."""
    all_ids = torch.arange(source.count, device=source.device)
    ids, _ = search(layers, source, metric, source_get(source, all_ids), sp,
                    query_block=query_block)
    hits = ids[:, 0].cpu().numpy() == np.arange(source.count)
    return float(hits.mean())


def _mask_diagonal(d: torch.Tensor, row_off: int, col_off: int) -> None:
    """In place: entries (i, j) with ``row_off + i == col_off + j`` -> +inf."""
    q, c = d.shape
    i0 = max(0, col_off - row_off)
    i1 = min(q, c + col_off - row_off)
    if i1 > i0:
        rows = torch.arange(i0, i1, device=d.device)
        d[rows, rows + (row_off - col_off)] = EMPTY_DIST


def blocked_topk_pairwise(
    queries: torch.Tensor,  # [Q, D]
    corpus_feats: torch.Tensor,  # [N, D]
    metric: Metric,
    k: int,
    row_block: int = 4096,
    col_block: int = 1 << 16,
    exclude_diag_offset: Optional[int] = None,
    fast: bool = False,
    oversample: int = 4,
):
    """Top-k by blocked pairwise distances with streaming merge.

    Bounds the live distance matrix to ``[row_block, col_block]``.  When
    ``exclude_diag_offset`` is set, entry (i, exclude_diag_offset + i) is
    masked (self-exclusion for within-corpus queries).  Returns (ids, dists)
    ``[Q, k]`` sorted ascending by ``(dist, id)``.

    ``fast=True`` is the million-row mode: it keeps ``oversample * k``
    survivors per block and restores exact ordering with a rerank of the
    survivors before cutting to ``k``.  Like the JAX package on a TPU, the
    scan of those blocks is a bf16 product with f32 accumulation on a CUDA
    tensor (fp32 on a CPU tensor) and the rerank is fp32; the JAX package
    selects survivors with ``approx_min_k``, here it is an exact
    ``torch.topk``, which can only raise recall.
    """
    queries, corpus_feats = queries.contiguous(), corpus_feats.contiguous()
    n = corpus_feats.shape[0]
    k = min(k, n)
    k_scan = min(k * oversample, n) if fast else k
    # bound the live [row_block, col_block] f32 matrix (see MATRIX_BYTE_BUDGET)
    col_eff = min(col_block, n)
    row_block = max(256, min(row_block, MATRIX_BYTE_BUDGET // (col_eff * 4)))

    # what the fast mode's kernel needs of the corpus is made once per call
    corpus = prepare_operand(corpus_feats, metric, exact=not fast)
    out_i, out_d = [], []
    for rs in range(0, queries.shape[0], row_block):
        q = queries[rs : rs + row_block]
        q_op = prepare_operand(q, metric, exact=not fast)
        best_i = best_d = None
        for cs in range(0, n, col_block):
            d = best_pairwise_distance(q_op, corpus.narrow(cs, cs + col_block), metric,
                                       exact=not fast)
            if exclude_diag_offset is not None:
                _mask_diagonal(d, exclude_diag_offset + rs, cs)
            dd, idx = torch.topk(d, min(k_scan, d.shape[1]), dim=-1, largest=False)
            # (dist, id) order, so ties are settled by id as lax.top_k settles
            # them by index
            idx, dd = sort_queue((idx + cs).to(ID_DTYPE), dd)
            if best_i is None:
                best_i, best_d = idx, dd
            else:
                s_i, s_d = sort_queue(torch.cat([best_i, idx], -1), torch.cat([best_d, dd], -1))
                best_i, best_d = s_i[:, :k_scan], s_d[:, :k_scan]
        if fast:
            # bound the [rows, k_scan, D] rerank gather like the scan blocks
            width = corpus_feats.shape[-1]
            rb = max(64, MATRIX_BYTE_BUDGET // max(1, k_scan * width * 4))
            rr_i, rr_d = [], []
            for ss in range(0, q.shape[0], rb):
                cand = best_i[ss : ss + rb]
                dd = batched_distance(q[ss : ss + rb], corpus_feats[cand], metric)
                if exclude_diag_offset is not None:
                    # when k_scan >= n the diag-masked entry survives the
                    # scan; keep it excluded through the rerank
                    own = torch.arange(cand.shape[0], device=cand.device)[:, None]
                    dd = torch.where(cand == own + (exclude_diag_offset + rs + ss), EMPTY_DIST, dd)
                ri, rd = sort_queue(cand, dd)
                rr_i.append(ri[:, :k])
                rr_d.append(rd[:, :k])
            best_i, best_d = torch.cat(rr_i), torch.cat(rr_d)
        out_i.append(best_i)
        out_d.append(best_d)
    return torch.cat(out_i), torch.cat(out_d)
