"""The blocked flat scan: every top-k of the port that scans rows in blocks
instead of walking a graph (``analysis.fast_flat_knn``,
``analysis.blocked_topk_pairwise``, ``QuantizedHnsw.search_exact``, the
sharded indexes' scans) runs :func:`blocked_scan`, and the exact rerank
behind it and behind routed or code-graph search is :func:`rerank_blocks`.

A scan's ``mode`` names its kernel: ``"exact"`` the pairwise-distance
kernel in fp32, ``"exhaustive"`` its fast mode (bf16 dots on the card),
``"binned"`` / ``"folded"`` the scan kernels, which reduce each distance
tile inside the kernel, on bf16 operands.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple, Union

import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE, MATRIX_BYTE_BUDGET
from parallel_hnsw_tpu_torch.graph import Source, is_host_source, source_effective_width, source_get
from parallel_hnsw_tpu_torch.ops.cuda_distance import Operand, best_pairwise_distance, prepare_operand
from parallel_hnsw_tpu_torch.ops.cuda_scan import LANES, binned_scan, folded_scan, scan_operand
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance
from parallel_hnsw_tpu_torch.ops.queues import sort_queue

# The JAX package's cut-offs, found on a TPU (PERF.md holds the three modes'
# times on the H100 for a later reset): a fast scan bins from BINNED_FROM
# rows, fast_flat_knn(scan_mode="auto") folds from FOLDED_FROM.  A binned
# block covers at least SCAN_BLOCK rows; TILE_C is the scan kernels' tile.
BINNED_FROM = 200_000
FOLDED_FROM = 2_000_000
SCAN_BLOCK = 1 << 19
TILE_C = 4096


def block_scan(n: int, fast: bool, block: int = SCAN_BLOCK) -> Tuple[str, int]:
    """The mode and corpus block of a scan over ``n`` rows decoded or
    gathered a block at a time (PQ codes, a shard's rows): binned from
    ``BINNED_FROM`` rows when ``fast``, on blocks of at least
    ``SCAN_BLOCK``, else pairwise; never folded."""
    if not fast:
        return "exact", block
    if n >= BINNED_FROM:
        return "binned", max(block, SCAN_BLOCK)
    return "exhaustive", block


def select_scan_mode(n: int) -> str:
    """Scan-engine frontier for ``fast_flat_knn(scan_mode="auto")``:
    exhaustive below ``BINNED_FROM`` rows (cheap, exact-id parity), binned
    below ``FOLDED_FROM``, folded from there."""
    return "folded" if n >= FOLDED_FROM else block_scan(n, fast=True)[0]


def flat_corpus_block(
    n: int,
    mode: str,
    fused: bool,
    query_block: int = 4096,
    corpus_block: int = SCAN_BLOCK,
    tile_c: int = TILE_C,
    dense: bool = True,
) -> int:
    """Rows of the corpus that one scan block of ``fast_flat_knn`` covers.

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


def cut_survivors(bin_d, bin_cols, offset: int, kk: int):
    """The ``kk`` smallest entries of ``bin_d`` as ``(ids, dists)`` sorted by
    ``(dist, id)``.  ``bin_cols`` maps a bin to its corpus column (``None``:
    the entries are the columns themselves); padding bins (``+inf``) become
    ``EMPTY_ID`` so the rerank excludes them (their gathers would otherwise
    clip to real rows)."""
    dd, pos = torch.topk(bin_d, min(kk, bin_d.shape[-1]), dim=-1, largest=False)
    ids = (pos if bin_cols is None else torch.gather(bin_cols, -1, pos)) + offset
    ids = torch.where(torch.isfinite(dd), ids, EMPTY_ID).to(ID_DTYPE)
    return sort_queue(ids, dd)


def cut_keeping_ids(d, bin_cols, offset: int, kk: int):
    """:func:`cut_survivors` of plain distances, where a ``+inf`` entry (a
    masked diagonal) keeps its id; ``(dist, id)`` order settles ties by id,
    as ``lax.top_k`` settles them by index."""
    dd, pos = torch.topk(d, min(kk, d.shape[-1]), dim=-1, largest=False)
    return sort_queue((pos + offset).to(ID_DTYPE), dd)


def _mask_diagonal(d: torch.Tensor, row_off: int, col_off: int) -> None:
    """In place: entries (i, j) with ``row_off + i == col_off + j`` -> +inf."""
    q, c = d.shape
    i0 = max(0, col_off - row_off)
    i1 = min(q, c + col_off - row_off)
    if i1 > i0:
        rows = torch.arange(i0, i1, device=d.device)
        d[rows, rows + (row_off - col_off)] = EMPTY_DIST


def _operand(m: torch.Tensor, metric: Metric, mode: str):
    if mode in ("binned", "folded"):
        return scan_operand(m.contiguous())
    return prepare_operand(m, metric, exact=mode == "exact")


def blocked_scan(queries: torch.Tensor, corpus: Union[torch.Tensor, Callable], n: int, metric: Metric,
                 mode: str, k_scan: int, block: int, query_block: int, *, cut: Callable = cut_survivors,
                 diag: Optional[int] = None, span: Optional[Callable] = None,
                 rerank: Optional[Source] = None, k: Optional[int] = None):
    """Each query's ``k_scan`` nearest of ``n`` rows by a ``mode`` scan in
    blocks of ``query_block`` queries and ``block`` rows, merged by
    ``(dist, id)``.  ``corpus`` is the rows (prepared for the kernel once,
    sliced per block) or ``corpus(start, stop)``, a block's rows (decoded
    codes, a memmap gather, a shard's rows).  ``cut(bin_d, bin_cols,
    offset, kk)`` cuts a block's survivors; ``diag`` masks entry
    ``(i, diag + i)``; ``span(q)`` opens a span around a query block's scan
    and gets ``code_blocks``, ``decoded_rows`` and ``survivors``.  With
    ``rerank``, a query block's survivors are reranked against that source
    (``diag``'s row excluded), the gather bound to the byte budget, and cut
    to ``k``."""
    metric = Metric(metric)
    queries = queries.contiguous()
    prepared = None if callable(corpus) else _operand(corpus, metric, mode)
    out_i, out_d = [], []
    for qs in range(0, max(1, queries.shape[0]), query_block):
        q = queries[qs : qs + query_block]
        with span(q) if span is not None else contextlib.nullcontext({}) as closing:
            q_op = _operand(q, metric, mode)
            best_i = best_d = None
            for blocks, cs in enumerate(range(0, n, block), 1):
                stop = min(cs + block, n)
                if prepared is None:
                    y = _operand(corpus(cs, stop), metric, mode)
                else:
                    y = prepared.narrow(cs, stop) if isinstance(prepared, Operand) else prepared[cs:stop]
                if mode == "folded":
                    bd, bc = folded_scan(q_op, y, metric, tile_c=TILE_C, exact=False)
                elif mode == "binned":
                    bd, bc = binned_scan(q_op, y, metric, tile_c=TILE_C, exact=False)
                else:
                    bd, bc = best_pairwise_distance(q_op, y, metric, exact=mode == "exact"), None
                if diag is not None:
                    _mask_diagonal(bd, diag + qs, cs)
                idx, dd = cut(bd, bc, cs, min(k_scan, stop - cs))
                if best_i is None:
                    best_i, best_d = idx, dd
                else:
                    s_i, s_d = sort_queue(torch.cat([best_i, idx], -1), torch.cat([best_d, dd], -1))
                    best_i, best_d = s_i[:, :k_scan], s_d[:, :k_scan]
            closing.update(code_blocks=blocks, decoded_rows=n, survivors=best_i.numel())
        if rerank is not None:
            own = None if diag is None else torch.arange(q.shape[0], device=q.device) + (diag + qs)
            rows = max(64, MATRIX_BYTE_BUDGET // max(1, k_scan * rerank.dim * 4))
            best_i, best_d = rerank_blocks(rerank, metric, q, best_i, rows, own)
            best_i, best_d = best_i[:, :k], best_d[:, :k]
        out_i.append(best_i)
        out_d.append(best_d)
    return torch.cat(out_i), torch.cat(out_d)


def rerank_blocks(source: Source, metric: Metric, queries: torch.Tensor, ids: torch.Tensor,
                  rows: int, exclude: Optional[torch.Tensor] = None):
    """Full-precision rescore + ``(dist, id)`` resort of candidate queues
    ``ids [Q, ef]`` in blocks of ``rows`` queries; ``EMPTY_ID`` and each
    query's ``exclude`` id (``[Q]``) score ``+inf``.  A host (out-of-core)
    source gathers a block's rows on the host and moves only them to the
    queries' device (reference seam: src/pq.rs:133-142)."""
    metric = Metric(metric)
    host = {"device": queries.device} if is_host_source(source) else {}
    out_i, out_d = [], []
    for qs in range(0, queries.shape[0], rows):
        block_ids = ids[qs : qs + rows]
        d = batched_distance(queries[qs : qs + rows], source_get(source, block_ids, **host), metric)
        drop = block_ids == EMPTY_ID
        if exclude is not None:
            drop |= block_ids == exclude[qs : qs + rows, None]
        r_ids, r_d = sort_queue(block_ids, torch.where(drop, EMPTY_DIST, d))
        out_i.append(r_ids)
        out_d.append(r_d)
    if len(out_i) == 1:
        return out_i[0], out_d[0]
    return torch.cat(out_i), torch.cat(out_d)


def exact_rerank(source: Source, metric: Metric, queries: torch.Tensor, ids: torch.Tensor,
                 block_budget: int = 1 << 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rerank_blocks` of routed graph search, the PQ pipeline and the
    out-of-core sharded index (reference rerank contract: src/pq.rs:354-363),
    in query blocks whose gathered ``[qb, ef, width]`` rows fit
    ``block_budget`` bytes, rows lane-padded as the JAX package pads them."""
    rows = max(16, block_budget // max(1, ids.shape[1] * source_effective_width(source) * 4))
    return rerank_blocks(source, metric, queries, ids, rows)
