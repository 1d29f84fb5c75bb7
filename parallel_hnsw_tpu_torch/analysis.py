"""Brute-force top-k, the fast flat scan, recall measurement and the graph
diagnostics (counterpart of ``parallel_hnsw_tpu.analysis``).

:func:`blocked_topk_pairwise` is where the main path reaches the
pairwise-distance kernel: exact build seeds, the exact and fast relink tiers
and :func:`brute_force_knn` all run through it.  :func:`fast_flat_knn` is
where the flat-scan path reaches the binned and folded scan kernels.  Both
are callers of :func:`parallel_hnsw_tpu_torch.flat.blocked_scan`, which owns
the choice of kernel, the survivor cut, the merge and the rerank.

The diagnostics (reference: src/lib.rs:279-548) are BFS distance maps from
super-nodes, reachability scans, argmin partitioning and promotion
discovery.  The reference's lock-free parallel BFS becomes a scatter-min
fixpoint over the layer's flattened edge list, as in the JAX package: the
same values bit for bit on any device, since an integer minimum does not
depend on the order of the updates.  They return numpy arrays, as the JAX
package's do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_ID, ID_DTYPE, MATRIX_BYTE_BUDGET
from parallel_hnsw_tpu_torch.flat import SCAN_BLOCK, blocked_scan, cut_keeping_ids
from parallel_hnsw_tpu_torch.flat import flat_corpus_block, select_scan_mode
from parallel_hnsw_tpu_torch.graph import (
    DenseSource,
    Layer,
    Source,
    gather_features,
    materialize_source,
    source_get,
    vec_to_node,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric, pairwise_distance
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.search import search
from parallel_hnsw_tpu_torch.utils.trace import TRACER

def brute_force_knn(
    source: Source, queries: torch.Tensor, metric: Metric, k: int, query_block: int = 4096
):
    """Exact top-k by full pairwise distances. Returns (ids, dists)."""
    vecs = materialize_source(source)
    return blocked_topk_pairwise(queries, vecs, metric, k, row_block=query_block)


def fast_flat_knn(
    source: Source,
    queries: torch.Tensor,
    metric: Metric,
    k: int,
    oversample: int = 4,
    query_block: int = 4096,
    corpus_block: int = SCAN_BLOCK,
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
    n = source.count
    mode = select_scan_mode(n) if scan_mode == "auto" else scan_mode
    if mode not in ("exhaustive", "binned", "folded"):
        raise ValueError(f"unknown scan_mode {scan_mode!r}")
    # a dense corpus's kernel operand is made once; a source that is not one
    # dense tensor is gathered block by block: a PqSource reconstructed on its
    # device, a MemmapSource gathered on the host and copied to the queries'
    # device (the corpus never is, whole)
    dense = isinstance(source, DenseSource)
    if dense:
        corpus = source.vectors
    else:
        all_ids = torch.arange(n, dtype=ID_DTYPE, device=queries.device)

        def corpus(start: int, stop: int) -> torch.Tensor:
            return gather_features(source, all_ids[start:stop])

    block = flat_corpus_block(n, mode, queries.is_cuda, query_block, corpus_block, dense=dense)
    return blocked_scan(queries, corpus, n, metric, mode, max(k, k * oversample), block,
                        query_block, rerank=source, k=k)


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


# ---------------------------------------------------------------------------
# BFS distance maps (reference: node_distances, src/lib.rs:425-489)

INF_I32 = torch.iinfo(torch.int32).max


def _edges(layer: Layer):
    """The layer's edges as flat ``(src int64, dst int64, cost int32)``, one
    per neighbor slot that holds a node of the layer; ``cost`` is the slot's
    position + 1.  ``EMPTY_ID`` slots drop, as the JAX package's
    out-of-bounds scatter drops them."""
    n, m = layer.neighbors.shape
    dst = layer.neighbors.reshape(-1).long()
    keep = ((dst >= 0) & (dst < n)).nonzero()[:, 0]
    return torch.div(keep, m, rounding_mode="floor"), dst[keep], (keep % m + 1).to(torch.int32)


def _relax(layer: Layer, hops: torch.Tensor):
    """``(hops [S, N], index_sum [S, N])`` int32 from the seeded state ``hops``
    (0 at each row's sources, INT32_MAX elsewhere; ``index_sum`` starts as
    its copy): Jacobi relaxation of both maps along every edge at once
    (``scatter_reduce`` amin), until neither changes.  The only read of the
    device is ``changed``, once per iteration; the iteration count goes to
    ``TRACER`` as a ``bfs_fixpoint`` counter.

    An unreached source (INT32_MAX) offers INT32_MAX, as in the JAX package;
    the candidates saturate there instead of masking, which is the same
    except where the JAX package's int32 index_sum would wrap (a path whose
    slot costs sum past 2**31 - 1)."""
    src, dst, cost = _edges(layer)
    cap = INF_I32 - cost
    isum = hops.clone()
    index = dst.expand(hops.shape[0], -1)
    iterations = 0
    while True:
        iterations += 1
        cand_h = hops[:, src].clamp_max_(INF_I32 - 1).add_(1)
        cand_s = isum[:, src].clamp_max_(cap).add_(cost)
        new_h = hops.scatter_reduce(1, index, cand_h, "amin")
        new_s = isum.scatter_reduce(1, index, cand_s, "amin")
        changed = bool(torch.any(new_h != hops) | torch.any(new_s != isum))
        hops, isum = new_h, new_s
        if not changed:
            break
    TRACER.count("bfs_fixpoint", iterations=iterations, rows=hops.shape[0],
                 nodes=hops.shape[1], edges=dst.shape[0])
    return hops, isum


def _ids_on(layer: Layer, ids) -> torch.Tensor:
    """Vector ids (a tensor, a numpy array or a sequence) as a 1-D int32
    tensor on the layer's device."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.asarray(ids, dtype=np.int32).reshape(-1))
    return ids.to(device=layer.nodes.device, dtype=ID_DTYPE).reshape(-1)


def _super_nodes(layer: Layer, supers) -> torch.Tensor:
    """Super vector ids as node ids of ``layer``, ``EMPTY_ID`` for a super
    that is not in it (it seeds nothing)."""
    return vec_to_node(layer.nodes, _ids_on(layer, supers))


def node_distances(layer: Layer, supers) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node (hops, index_sum) distance to the nearest super-node.

    The reference runs a lock-free parallel BFS with atomic CAS on hops and
    fetch-min on index_sum (src/lib.rs:425-489; index_sum = sum of
    (neighbor-slot position + 1) along the path).  Here both relax to a
    fixpoint from every super at once, which is deterministic where the
    reference's index_sum depends on scheduling.

    Returns numpy ``(hops [N], index_sum [N])`` int32 with INT32_MAX =
    unreachable.
    """
    super_nodes = _super_nodes(layer, supers)
    hops = torch.full((1, layer.node_count), INF_I32, dtype=torch.int32,
                      device=layer.nodes.device)
    hops[0, super_nodes[super_nodes != EMPTY_ID].long()] = 0
    hops, isum = _relax(layer, hops)
    return hops[0].cpu().numpy(), isum[0].cpu().numpy()


def nodes_unreachable_from_all_supers(layer: Layer, supers) -> np.ndarray:
    """Node ids unreachable from every super."""
    hops, _ = node_distances(layer, supers)
    return np.nonzero(hops == INF_I32)[0].astype(np.int32)


def per_super_node_distances(
    layer: Layer, supers, chunk: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(super, node) BFS distances ``(hops [S, N], index_sum [S, N])``.

    The batched generalization of the reference's labeled multi-source BFS
    (multi_node_distances, src/lib.rs:323-383): each super floods the layer
    on its own; supers go in chunks of ``chunk``, each chunk one fixpoint
    over ``[chunk, N]`` maps (its temporaries are ``[chunk, edges]``).
    """
    super_nodes = _super_nodes(layer, supers)
    s_total, n = super_nodes.shape[0], layer.node_count
    out_h = np.full((s_total, n), INF_I32, np.int32)
    out_s = np.full((s_total, n), INF_I32, np.int32)
    for start in range(0, s_total, chunk):
        nodes = super_nodes[start : start + chunk]
        hops = torch.full((nodes.shape[0], n), INF_I32, dtype=torch.int32, device=nodes.device)
        rows = (nodes != EMPTY_ID).nonzero()[:, 0]
        hops[rows, nodes[rows].long()] = 0
        h, s_ = _relax(layer, hops)
        out_h[start : start + chunk] = h.cpu().numpy()
        out_s[start : start + chunk] = s_.cpu().numpy()
    return out_h, out_s


def multi_node_distances(
    layer: Layer, supers, k: int = 5, chunk: int = 64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per node, the ``k`` supers with the smallest (hops, index_sum) BFS
    distance (reference: multi_node_distances::<5>, src/lib.rs:323-383;
    deterministic where the reference records discovery order).

    Returns ``(super_idx [N, k], hops [N, k], index_sum [N, k])`` with -1 /
    INT32_MAX padding for unreached entries.
    """
    hops, isum = per_super_node_distances(layer, supers, chunk)
    order = np.lexsort((isum, hops), axis=0)[:k]  # [k, N]
    top_h = np.take_along_axis(hops, order, axis=0).T
    top_s = np.take_along_axis(isum, order, axis=0).T
    sup_idx = order.T.astype(np.int32)
    sup_idx = np.where(top_h == INF_I32, -1, sup_idx)
    return sup_idx, top_h, top_s


def node_distances_from_closest_super(
    layer: Layer, source: Source, metric: Metric, supers, chunk: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """BFS distance of every node from its *geometrically closest* super
    (reference: node_distances_from_closest_super, src/lib.rs:385-412)."""
    part = group_nodes_by_vectors(layer, source, metric, supers)  # [N] super idx
    hops, isum = per_super_node_distances(layer, supers, chunk)
    n = layer.node_count
    return hops[part, np.arange(n)], isum[part, np.arange(n)]


def nodes_not_connected_to_super(
    layer: Layer, source: Source, metric: Metric, supers
) -> np.ndarray:
    """Node ids not reachable from their closest super (reference:
    nodes_not_connected_to_super, src/lib.rs:414-422)."""
    hops, _ = node_distances_from_closest_super(layer, source, metric, supers)
    return np.nonzero(hops == INF_I32)[0].astype(np.int32)


def discover_nodes_to_promote(layer: Layer, supers) -> np.ndarray:
    """Unreachable nodes ordered worst-first (reference: src/lib.rs:510-536):
    sort by descending index_sum, then descending hops, then node id; keep the
    BFS-unreachable prefix."""
    hops, isum = node_distances(layer, supers)
    order = np.lexsort((np.arange(len(hops)), -hops.astype(np.int64), -isum.astype(np.int64)))
    unreachable = hops[order] == INF_I32
    return order[unreachable].astype(np.int32)


def reachables_from(layer: Layer, node: int, check: Sequence[int]) -> list:
    """DFS reachability restricted to ``check`` (reference: src/lib.rs:491-508),
    on a host copy of the neighbor rows.  Returns [(node, path_cost)] in
    discovery order."""
    neighbors = layer.neighbors.cpu().numpy()
    remaining = set(int(c) for c in check)
    result = [(int(node), 0)]
    stack = [(int(node), 0)]
    while stack:
        cur, dist = stack.pop()
        for ix, nb in enumerate(neighbors[cur]):
            nb = int(nb)
            if nb != EMPTY_ID and nb in remaining:
                remaining.discard(nb)
                nd = dist + ix + 1
                stack.append((nb, nd))
                result.append((nb, nd))
    return result


def group_nodes_by_vectors(layer: Layer, source: Source, metric: Metric, vectors) -> np.ndarray:
    """Partition nodes by nearest vector in ``vectors`` (reference:
    group_nodes_by_vectors, src/lib.rs:279-321).  Returns, per node, the index
    into ``vectors`` of its closest super (the first on a tie).  One plain
    fp32 ``pairwise_distance`` of every node against every vector, as the
    JAX package computes it outside its distance kernel."""
    node_feats = source_get(source, layer.nodes)
    d = pairwise_distance(node_feats, source_get(source, _ids_on(layer, vectors)), metric)
    return torch.argmin(d, dim=-1).to(torch.int32).cpu().numpy()


def reverse_get_neighbors(layer: Layer, node: int) -> np.ndarray:
    """All nodes whose row contains ``node`` (reference: src/lib.rs:538-548)."""
    neighbors = layer.neighbors.cpu().numpy()
    return np.nonzero((neighbors == int(node)).any(axis=1))[0].astype(np.int32)


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
    ``torch.topk``, which can only raise recall.  A survivor the diagonal
    masked keeps its id at ``+inf``, and stays excluded through the rerank.
    """
    corpus_feats = corpus_feats.contiguous()
    n = corpus_feats.shape[0]
    k = min(k, n)
    k_scan = min(k * oversample, n) if fast else k
    # bound the live [row_block, col_block] f32 matrix (see MATRIX_BYTE_BUDGET)
    col_eff = min(col_block, n)
    row_block = max(256, min(row_block, MATRIX_BYTE_BUDGET // (col_eff * 4)))
    return blocked_scan(
        queries, corpus_feats, n, metric, "exhaustive" if fast else "exact", k_scan, col_block,
        row_block, cut=cut_keeping_ids, diag=exclude_diag_offset,
        rerank=DenseSource(corpus_feats) if fast else None, k=k,
    )
