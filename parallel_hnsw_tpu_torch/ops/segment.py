"""Segmented top-M neighbor-row rebuild (counterpart of ``parallel_hnsw_tpu.ops.segment``).

Emit all candidate edges as ``(dst, src, dist)`` triples, globally sort, dedup
``(dst, src)`` pairs, rank within each ``dst`` segment, keep ranks < M, and
scatter into a fresh ``[N, M]`` slab.  The result equals the best-M of the
union of all inserted edges, independent of insertion order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from parallel_hnsw_tpu_torch.constants import DIST_DTYPE, EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.ops.queues import lexsort_perm

# Cap on one flat sort's element count, kept at the JAX package's value so
# both fold the same chunks; larger edge lists fold through bounded chunks
# merged row-wise below.
MAX_SORT_ELEMENTS = 8 << 20


def rebuild_rows(
    n_rows: int,
    m: int,
    dst: torch.Tensor,  # [E] int32 row ids (EMPTY_ID = invalid)
    src: torch.Tensor,  # [E] int32 neighbor node ids
    dist: torch.Tensor,  # [E] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the best ``m`` unique ``src`` per ``dst`` row, sorted by
    ``(dist, src)``.  Returns ``(neighbors [n_rows, m], dists [n_rows, m])``
    with EMPTY padding.

    Edge lists beyond MAX_SORT_ELEMENTS are processed as a fold: each chunk
    rebuilds a partial slab and slabs merge row-wise with
    dedup-by-src-keep-min — identical to the single-shot rebuild because a
    fixed-capacity best-m union is associative."""
    e = dst.shape[0]
    if e <= MAX_SORT_ELEMENTS:
        return _rebuild_rows_flat(n_rows, m, dst, src, dist)
    acc_i = acc_d = None
    for s in range(0, e, MAX_SORT_ELEMENTS):
        part = slice(s, s + MAX_SORT_ELEMENTS)
        pi, pd = _rebuild_rows_flat(n_rows, m, dst[part], src[part], dist[part])
        if acc_i is None:
            acc_i, acc_d = pi, pd
        else:
            acc_i, acc_d = _merge_slabs(acc_i, acc_d, pi, pd, m)
    return acc_i, acc_d


def _merge_slabs(a_i, a_d, b_i, b_d, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise best-m merge of two (dist, src)-sorted EMPTY-padded slabs,
    dedup by src keeping the smaller distance."""
    cat_i = torch.cat([a_i, b_i], dim=-1)
    cat_d = torch.cat([a_d, b_d], dim=-1)
    # group by src: (src, dist) lex sort puts duplicates adjacent, best first
    perm = lexsort_perm(cat_i, cat_d)
    i1 = torch.gather(cat_i, -1, perm)
    d1 = torch.gather(cat_d, -1, perm)
    dup = torch.zeros_like(i1, dtype=torch.bool)
    dup[..., 1:] = (i1[..., 1:] == i1[..., :-1]) & (i1[..., 1:] != EMPTY_ID)
    i1 = torch.where(dup, EMPTY_ID, i1)
    d1 = torch.where(dup, EMPTY_DIST, d1)
    # rank by (dist, src)
    perm = lexsort_perm(d1, i1)
    # contiguous: the slab becomes a layer's neighbor table, which the
    # row-gather kernel copies row by row
    return (torch.gather(i1, -1, perm)[..., :m].contiguous(),
            torch.gather(d1, -1, perm)[..., :m].contiguous())


def _rebuild_rows_flat(
    n_rows: int,
    m: int,
    dst: torch.Tensor,
    src: torch.Tensor,
    dist: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    # drop self-edges and invalid entries
    invalid = (dst == src) | (dst == EMPTY_ID) | (src == EMPTY_ID) | ~torch.isfinite(dist)
    dst = torch.where(invalid, EMPTY_ID, dst)
    src = torch.where(invalid, EMPTY_ID, src)
    dist = torch.where(invalid, EMPTY_DIST, dist)

    # pass 1: sort by (dst, src, dist); mark later duplicates of (dst, src)
    perm = lexsort_perm(dst, src, dist)
    dst1, src1, dist1 = dst[perm], src[perm], dist[perm]
    dup = torch.zeros_like(dst1, dtype=torch.bool)
    dup[1:] = (dst1[1:] == dst1[:-1]) & (src1[1:] == src1[:-1]) & (dst1[1:] != EMPTY_ID)
    dst1 = torch.where(dup, EMPTY_ID, dst1)
    src1 = torch.where(dup, EMPTY_ID, src1)
    dist1 = torch.where(dup, EMPTY_DIST, dist1)

    # pass 2: sort by (dst, dist, src) — row-major best-first.  Pass 1 left
    # every (dst, dist) tie in src order, so a stable (dst, dist) sort is it.
    perm = lexsort_perm(dst1, dist1)
    dst2, dist2, src2 = dst1[perm], dist1[perm], src1[perm]

    # rank within each dst segment
    e = dst2.shape[0]
    seg_start = torch.searchsorted(dst2, dst2, side="left")
    rank = torch.arange(e, device=dst2.device) - seg_start

    # JAX drops out-of-bounds scatters; here rejected edges go to a spare
    # row n_rows that is cut off afterwards, so no index is ever out of range
    keep = (rank < m) & (dst2 != EMPTY_ID)
    rows = torch.where(keep, dst2.long(), n_rows)
    cols = torch.where(keep, rank, 0)
    neighbors = torch.full((n_rows + 1, m), EMPTY_ID, dtype=ID_DTYPE, device=dst.device)
    dists = torch.full((n_rows + 1, m), EMPTY_DIST, dtype=DIST_DTYPE, device=dst.device)
    neighbors[rows, cols] = src2
    dists[rows, cols] = dist2
    return neighbors[:n_rows], dists[:n_rows]


def symmetrize(
    neighbors: torch.Tensor,  # [N, M] node-id rows (EMPTY-padded)
    dists: torch.Tensor,  # [N, M] matching distances
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Make neighborhoods bidirectional (reference: src/lib.rs:795-815).

    Final row r = best-M of {r's forward edges} ∪ {reverse edges (s, r, d) for
    every forward edge (r in s's row)}.
    """
    n, m = neighbors.shape
    row_ids = torch.arange(n, dtype=ID_DTYPE, device=neighbors.device)[:, None].expand(n, m)
    fwd_dst = row_ids.reshape(-1)
    fwd_src = neighbors.reshape(-1)
    fwd_d = dists.reshape(-1)
    all_dst = torch.cat([fwd_dst, fwd_src])
    all_src = torch.cat([fwd_src, fwd_dst])
    all_d = torch.cat([fwd_d, fwd_d])
    return rebuild_rows(n, m, all_dst, all_src, all_d)
