"""Routing vectors and hop slabs: compact hop-scoring state for graph
traversal (counterpart of ``parallel_hnsw_tpu.routing``).

The reference declares a ``PartialDistance`` trait for cheap partial scoring
during traversal but never implements it (src/pq.rs:24-27).  The realization
here keeps the hop at one row gather per candidate and shrinks the bytes
under that gather: project the corpus once to a narrow routing matrix
``[N, dr]`` in bfloat16 (a random orthonormal Johnson-Lindenstrauss
projection preserves distance *order* well enough to steer traversal), score
every hop against routing rows, and restore exact ranking with one
full-precision rerank of the final candidate queue: the same
oversample-then-rerank contract as the fast flat scans
(:func:`~parallel_hnsw_tpu_torch.flat.exact_rerank`, which this module
exports under the JAX package's name for it).

``dr=None`` skips the projection and just casts to bf16: halved traffic with
near-exact routing, for corpora whose dimension is already small.

Hop slabs pack the feature rows of a node's M neighbors into one row, so a
hop gathers one long row per expanded node instead of M short ones.

Both are derived, recomputable state.  Every gather goes through the
hand-written row-gather kernel on a CUDA source.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import ID_DTYPE
from parallel_hnsw_tpu_torch.flat import exact_rerank  # noqa: F401
from parallel_hnsw_tpu_torch.graph import Layer, Source, node_to_vec, source_get
from parallel_hnsw_tpu_torch.ops.cuda_gather import row_gather
from parallel_hnsw_tpu_torch.ops.distance import Metric, check_fp32_matmul


class RoutingCache(NamedTuple):
    """Derived (recomputable) traversal acceleration state."""

    projection: Optional[torch.Tensor]  # [D, dr] f32 orthonormal, or None
    rows: torch.Tensor  # [N, dr] bf16 routing rows
    metric: Metric  # metric evaluated in routed space


def route_metric(metric: Metric) -> Metric:
    """Metric evaluated during routed traversal.

    EUCLIDEAN drops the final sqrt: squared distances are order-equivalent
    and cheaper.  Every other metric keeps its form (cosine-family rows are
    re-normalized after projection so dots stay cosines).
    """
    metric = Metric(metric)
    if metric is Metric.EUCLIDEAN:
        return Metric.SQUARED_EUCLIDEAN
    return metric


def random_orthonormal(dim: int, dr: int, seed: int = 0, device=None) -> torch.Tensor:
    """Random orthonormal ``[dim, dr]`` projection (QR of a gaussian).

    The gaussian comes from a numpy generator seeded with ``seed`` (the JAX
    package draws it from ``jax.random``, so the two packages' projections
    differ; hand one in through ``build_routing(projection=...)`` to share
    it).  The QR runs on the host; the result goes to ``device``."""
    if dr > dim:
        raise ValueError(f"routing dim {dr} exceeds source dim {dim}")
    g = np.random.default_rng(seed).standard_normal((dim, dr)).astype(np.float32)
    q, _ = torch.linalg.qr(torch.from_numpy(g))
    return q.to(device)


def _transform(
    feats: torch.Tensor, projection: Optional[torch.Tensor], metric: Metric
) -> torch.Tensor:
    if projection is not None:
        feats = feats.float()
        check_fp32_matmul(feats)
        feats = feats @ projection
    if Metric(metric) in (Metric.COSINE, Metric.NORMALIZED_COSINE):
        norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        feats = feats / torch.clamp(norm, min=1e-12)
    return feats


def build_routing(
    source: Source,
    metric: Metric,
    dr: Optional[int] = 64,
    seed: int = 0,
    block: int = 131072,
    projection: Optional[torch.Tensor] = None,
) -> RoutingCache:
    """Project (or just bf16-cast) a source into a routing cache, streamed in
    row blocks.  A given ``projection`` ``[D, dr]`` is used as it is."""
    metric = Metric(metric)
    dim = source.dim
    if projection is None and dr is not None and dr < dim:
        projection = random_orthonormal(dim, dr, seed, device=source.device)
    ids = torch.arange(source.count, dtype=ID_DTYPE, device=source.device)
    outs = []
    for start in range(0, source.count, block):
        feats = source_get(source, ids[start : start + block])
        outs.append(_transform(feats, projection, metric).to(torch.bfloat16))
    return RoutingCache(
        projection=projection,
        rows=torch.cat(outs) if len(outs) > 1 else outs[0],
        metric=route_metric(metric),
    )


def route_queries(cache: RoutingCache, queries: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Apply the cache's transform to queries (kept f32 for stable ordering)."""
    return _transform(queries, cache.projection, metric)


# ---------------------------------------------------------------------------
# Neighbor-major hop slabs


class HopSlabs(NamedTuple):
    """Per-layer neighbor-major feature slabs for gather-light traversal.

    ``slabs[i][n, j]`` holds the (routing-space) features of
    ``layers[i].neighbors[n, j]``: one slab row per node packs all M
    neighbor feature rows, so the hop gathers ONE long row per expanded node
    instead of M short ones, at the price of M-fold feature duplication in
    device memory.  Derived (recomputable) state: any layer mutation
    invalidates it.

    ``routed`` records whether rows live in a routing cache's space (score
    with routed queries + exact final rerank) or in the source's native
    space (results bit-identical to the plain hop when f32).
    """

    slabs: Tuple[torch.Tensor, ...]  # per layer [N, M, width]
    routed: bool


def build_hop_slabs(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    routing: Optional[RoutingCache] = None,
    byte_budget: int = 4 << 30,
) -> HopSlabs:
    """Materialize neighbor-feature slabs for every layer, one row gather
    per layer.

    With ``routing`` given, slab rows are the cache's bf16 (optionally
    projected) rows, the memory knob for large corpora: slab bytes are
    ``sum(N_i * M_i) * width * itemsize``, with the width as stored (the JAX
    package budgets f32 rows at their 128-lane-padded width and pads layers
    to node buckets; neither exists here).  Raises if the total exceeds
    ``byte_budget``.
    """
    rows = routing.rows if routing is not None else None
    width = int(rows.shape[1]) if rows is not None else source.dim
    itemsize = 2 if rows is not None else 4
    total = sum(l.neighbors.numel() * width * itemsize for l in layers)
    if total > byte_budget:
        raise ValueError(
            f"hop slabs need {total / 1e9:.2f} GB (> budget "
            f"{byte_budget / 1e9:.2f} GB); enable_routing with a smaller dr "
            "or raise byte_budget"
        )
    slabs = []
    for layer in layers:
        n, m = layer.neighbors.shape
        vids = node_to_vec(layer.nodes, layer.neighbors.reshape(-1))
        if rows is not None:
            feats = row_gather(rows, torch.clamp(vids, 0, rows.shape[0] - 1))
        else:
            feats = source_get(source, vids)
        slabs.append(feats.reshape(n, m, feats.shape[-1]))
    return HopSlabs(slabs=tuple(slabs), routed=routing is not None)
