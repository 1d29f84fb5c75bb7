"""Brute-force top-k and recall measurement
(counterpart of the main-path part of ``parallel_hnsw_tpu.analysis``).

:func:`blocked_topk_pairwise` is where the main path reaches the
pairwise-distance kernel: exact build seeds, the exact and fast relink tiers
and :func:`brute_force_knn` all run through it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, ID_DTYPE
from parallel_hnsw_tpu_torch.graph import Layer, Source, materialize_source, source_get
from parallel_hnsw_tpu_torch.ops.cuda_distance import best_pairwise_distance
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance
from parallel_hnsw_tpu_torch.ops.queues import sort_queue
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.search import search

# Cap on any transient [rows, cols] f32 distance matrix a blocked scan may
# materialize; kept at the JAX package's value so both packages cut the same
# blocks (to be measured again on the GPU).
MATRIX_BYTE_BUDGET = 512 << 20


def brute_force_knn(
    source: Source, queries: torch.Tensor, metric: Metric, k: int, query_block: int = 4096
):
    """Exact top-k by full pairwise distances. Returns (ids, dists)."""
    vecs = materialize_source(source)
    return blocked_topk_pairwise(queries, vecs, metric, k, row_block=query_block)


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
    survivors before cutting to ``k``.  The JAX package scans those blocks at
    bf16 MXU precision with ``approx_min_k``; here the kernel stays fp32 and
    the survivor selection is an exact ``torch.topk``, which can only raise
    recall.
    """
    queries, corpus_feats = queries.contiguous(), corpus_feats.contiguous()
    n = corpus_feats.shape[0]
    k = min(k, n)
    k_scan = min(k * oversample, n) if fast else k
    # bound the live [row_block, col_block] f32 matrix (see MATRIX_BYTE_BUDGET)
    col_eff = min(col_block, n)
    row_block = max(256, min(row_block, MATRIX_BYTE_BUDGET // (col_eff * 4)))

    out_i, out_d = [], []
    for rs in range(0, queries.shape[0], row_block):
        q = queries[rs : rs + row_block]
        best_i = best_d = None
        for cs in range(0, n, col_block):
            c = corpus_feats[cs : cs + col_block]
            d = best_pairwise_distance(q, c, metric, exact=not fast)
            if exclude_diag_offset is not None:
                _mask_diagonal(d, exclude_diag_offset + rs, cs)
            dd, idx = torch.topk(d, min(k_scan, c.shape[0]), dim=-1, largest=False)
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
