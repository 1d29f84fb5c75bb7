"""Bulk batch-parallel graph construction (counterpart of ``parallel_hnsw_tpu.build``).

Layer sizes form a geometric ladder (``calculate_partitions``,
src/lib.rs:1883-1899); each layer is built in one shot by (1) seeding every
node with its nearest stack-bottom vectors (brute force, or a search over the
stack above), (2) grouping nodes by their nearest seed, (3) drawing an
exponentially-distributed random candidate pool across the node's seed
partitions (``choose_n``, src/lib.rs:1854-1881), (4) keeping the best M by
distance, and (5) symmetrizing with reverse edges.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.graph import (
    Layer,
    Source,
    gather_features,
    node_to_vec,
    source_effective_width,
    source_get,
    vec_to_node,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance, pairwise_distance
from parallel_hnsw_tpu_torch.ops.queues import dedup_sorted, sort_queue
from parallel_hnsw_tpu_torch.ops.segment import symmetrize
from parallel_hnsw_tpu_torch.params import BuildParams, SearchParams
from parallel_hnsw_tpu_torch.search import search
from parallel_hnsw_tpu_torch.utils.trace import TRACER


# ---------------------------------------------------------------------------
# Layer-size ladder (reference: src/lib.rs:1883-1899). float32 math mirrored.


def calculate_partitions_from_bottom(total_size: int, order: int) -> List[int]:
    layer_count = max(
        1, int(math.ceil(np.log(np.float32(total_size)) / np.log(np.float32(order))))
    )
    partitions = []
    size = total_size
    for _ in range(layer_count):
        partitions.append(size)
        size //= order
    return partitions


def calculate_partitions(total_size: int, order: int) -> List[int]:
    return list(reversed(calculate_partitions_from_bottom(total_size, order)))


# ---------------------------------------------------------------------------
# generate_layer


def pool_draws(seed: int, slice_length: int, n: int, c: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform ``[n, c]`` arrays of :func:`_candidate_pool`, drawn
    from a generator seeded by ``(seed, slice_length)``: rung sizes strictly
    increase down the ladder, so every rung of a build gets its own stream,
    as the JAX package's ``fold_in(key, slice_length)`` gives."""
    mixed = np.random.SeedSequence([seed, slice_length]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed))
    u_exp = torch.rand((n, c), generator=gen, device=device)
    u_exp = torch.clamp(u_exp * (1.0 - 1e-7) + 1e-7, min=1e-7)  # uniform in [1e-7, 1)
    u_mem = torch.rand((n, c), generator=gen, device=device)
    return u_exp, u_mem


def _candidate_pool(
    u_exp: torch.Tensor,  # [N, C] uniform in [1e-7, 1)
    u_mem: torch.Tensor,  # [N, C] uniform in [0, 1)
    seed_nodes: torch.Tensor,  # [N, S] node ids
    n: int,
) -> torch.Tensor:
    """Per-node random candidate picks across seed partitions.

    Mirrors the partition-group + ``choose_n`` structure of the reference
    (src/lib.rs:711-746): partition of a node = its nearest seed; a node's
    pool is drawn from the partition groups of its seeds with an Exp(1)
    partition choice, uniform within the partition.  Given the same draws it
    matches the JAX package's pool exactly.
    """
    part = seed_nodes[:, 0].contiguous()  # [N] partition key (EMPTY for seedless nodes)
    sorted_part, order = torch.sort(part, stable=True)  # node ids sorted by partition
    order = order.to(ID_DTYPE)

    seeds = seed_nodes.contiguous()
    starts = torch.searchsorted(sorted_part, seeds, side="left")
    ends = torch.searchsorted(sorted_part, seeds, side="right")
    counts = torch.where(seeds != EMPTY_ID, ends - starts, 0)
    nonempty = counts > 0  # [N, S]
    n_nonempty = nonempty.sum(dim=-1)  # [N]

    own_start = torch.searchsorted(sorted_part, part, side="left")
    own_count = torch.searchsorted(sorted_part, part, side="right") - own_start

    # Exp(1) partition index, reset to 0 when out of range (reference:
    # src/lib.rs:1869-1872)
    j = torch.floor(-torch.log(u_exp)).to(torch.int64)
    j = torch.where(j >= n_nonempty[:, None], 0, j)

    # map j to the j-th non-empty seed partition (first match, as jnp.argmax)
    csum = torch.cumsum(nonempty.to(torch.int64), dim=-1)  # [N, S]
    match = (csum[:, None, :] == (j[:, :, None] + 1)) & nonempty[:, None, :]
    sel_s = torch.argmax(match.to(torch.uint8), dim=-1)  # [N, C]

    start_j = torch.gather(starts, 1, sel_s)
    count_j = torch.gather(counts, 1, sel_s)
    has_any = (n_nonempty > 0)[:, None]
    start_j = torch.where(has_any, start_j, own_start[:, None])
    count_j = torch.where(has_any, count_j, own_count[:, None])

    u = torch.floor(u_mem * count_j.to(torch.float32)).to(torch.int64)
    u = torch.minimum(torch.clamp(u, min=0), torch.clamp(count_j - 1, min=0))
    pick_pos = torch.clamp(start_j + u, 0, n - 1)
    cand = order[pick_pos]
    return torch.where(count_j > 0, cand, EMPTY_ID).to(ID_DTYPE)


def _build_rows_block(
    vs,  # [N] full sorted vector ids (for id mapping)
    vs_block,  # [B] this block's vector ids
    seed_nodes,  # [B, S] node ids
    seed_dists,  # [B, S]
    cand,  # [B, C] node ids (random pool)
    source: Source,
    metric: Metric,
    m: int,
    offset: int,
):
    """Distance-sort each node's (seeds ∪ pool), dedup, drop self, take M
    (reference: src/lib.rs:748-786).  One node block; blocks bound the
    gathered ``[B, C, D]`` working set for huge layers."""
    b = vs_block.shape[0]
    own_vecs = source_get(source, vs_block)  # [B, D]
    cand_vec_ids = node_to_vec(vs, cand)
    d = batched_distance(own_vecs, source_get(source, cand_vec_ids), metric)
    cand = torch.where(cand_vec_ids == EMPTY_ID, EMPTY_ID, cand)
    d = torch.where(cand != EMPTY_ID, d, EMPTY_DIST)

    all_ids = torch.cat([seed_nodes, cand], dim=-1)
    all_d = torch.cat([seed_dists, d], dim=-1)
    self_node = offset + torch.arange(b, dtype=ID_DTYPE, device=vs.device)[:, None]
    is_self = all_ids == self_node
    all_ids = torch.where(is_self, EMPTY_ID, all_ids)
    all_d = torch.where(is_self, EMPTY_DIST, all_d)

    u_ids, u_d = dedup_sorted(*sort_queue(all_ids, all_d))
    return u_ids[:, :m], u_d[:, :m]


def _build_rows(vs, seed_nodes, seed_dists, cand, source, metric, m, node_block):
    n = vs.shape[0]
    outs_i, outs_d = [], []
    for start in range(0, n, node_block):
        stop = min(start + node_block, n)
        ids, d = _build_rows_block(
            vs, vs[start:stop], seed_nodes[start:stop], seed_dists[start:stop],
            cand[start:stop], source, metric, m, start,
        )
        outs_i.append(ids)
        outs_d.append(d)
    return torch.cat(outs_i), torch.cat(outs_d)


def _auto_node_block(c: int, eff_width: int, budget_bytes: int = 2 << 30) -> int:
    """Node-block size bounding the gathered [block, c, width] f32 working set
    (kept at the JAX package's budget; to be measured again on the GPU)."""
    block = budget_bytes // max(1, c * eff_width * 4)
    return int(max(64, min(16384, block)))


def _seed_top_layer(
    vs: torch.Tensor, source: Source, metric: Metric, m: int, noc: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force seeds when there is no stack above (reference:
    ``compare_all``, src/search.rs:13-30).  Seed width is widened to ~2M so
    small top layers get near-exact rows like the reference's full scan."""
    n = vs.shape[0]
    s = min(n - 1, max(noc, 2 * m + 8))
    vecs = source_get(source, vs)
    d = pairwise_distance(vecs, vecs, metric)
    d.fill_diagonal_(EMPTY_DIST)
    # a stable sort keeps lax.top_k's lower-index-first order among ties
    sd, idx = torch.sort(d, dim=-1, stable=True)
    return idx[:, :s].to(ID_DTYPE), sd[:, :s]


def generate_layer(
    draws: Tuple[torch.Tensor, torch.Tensor],
    vs: torch.Tensor,  # [N] vector ids (will be sorted)
    neighborhood_size: int,
    stack: Sequence[Layer],
    source: Source,
    metric: Metric,
    initial_partition_search: SearchParams,
    node_block: int = 0,
    exact_seed_threshold: int = 131072,
) -> Layer:
    """Build one layer in bulk (reference: Hnsw::generate_layer,
    src/lib.rs:675-823).  ``draws`` are the candidate pool's uniform
    ``(u_exp, u_mem)`` arrays, each ``[len(vs), 5 * neighborhood_size]``
    (see :func:`pool_draws`).  ``node_block`` bounds per-launch working sets
    for huge layers; 0 = auto from a byte budget."""
    vs = torch.sort(vs.to(ID_DTYPE)).values
    n = int(vs.shape[0])
    m = neighborhood_size
    if node_block <= 0:
        node_block = _auto_node_block(m * 5, source_effective_width(source))

    if n == 1:
        return Layer(nodes=vs, neighbors=torch.full((1, m), EMPTY_ID, dtype=ID_DTYPE, device=vs.device))

    if len(stack) == 0:
        seed_nodes, seed_dists = _seed_top_layer(
            vs, source, metric, m, initial_partition_search.number_of_candidates
        )
    else:
        noc = initial_partition_search.number_of_candidates
        queries = gather_features(source, vs)
        bottom = stack[-1]
        if 0 < exact_seed_threshold and bottom.node_count <= exact_seed_threshold:
            # exact seeds: nearest stack-bottom vectors by blocked brute force
            # (the graph search's result set is exactly "nearest among the
            # deepest stack layer")
            from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise

            corpus_feats = gather_features(source, bottom.nodes)
            top_i, top_d = blocked_topk_pairwise(
                queries, corpus_feats, metric, noc + 1, row_block=node_block
            )
            res_ids = node_to_vec(bottom.nodes, top_i)
            drop = res_ids == vs[:, None]
            res_ids = torch.where(drop, EMPTY_ID, res_ids)
            top_d = torch.where(drop, EMPTY_DIST, top_d)
            res_ids, res_dists = sort_queue(res_ids, top_d)
        else:
            res_ids, res_dists = search(
                list(stack), source, metric, queries, initial_partition_search,
                exclude=vs, query_block=node_block,
            )
        seed_nodes = vec_to_node(vs, res_ids[:, :noc])
        seed_dists = torch.where(seed_nodes == EMPTY_ID, EMPTY_DIST, res_dists[:, :noc])

    u_exp, u_mem = draws
    cand = _candidate_pool(u_exp, u_mem, seed_nodes, n)
    fwd_ids, fwd_d = _build_rows(
        vs, seed_nodes, seed_dists, cand, source, metric, m, node_block
    )
    neighbors, _ = symmetrize(fwd_ids, fwd_d)
    return Layer(nodes=vs, neighbors=neighbors)


# ---------------------------------------------------------------------------
# Full ladder build


def generate(
    source: Source,
    vector_ids,
    bp: BuildParams,
    metric: Metric,
    seed: int = 0,
    improver=None,
) -> List[Layer]:
    """Build the full layer stack top-down (reference: Hnsw::generate,
    src/lib.rs:825-893).

    ``improver(layers) -> layers`` is invoked after every layer (the reference
    calls ``improve_index`` there, src/lib.rs:876); the index-level wrapper
    wires in the optimization loop to avoid a module cycle.
    """
    rng = np.random.default_rng(seed)
    if isinstance(vector_ids, torch.Tensor):
        vector_ids = vector_ids.cpu().numpy()
    vs = np.asarray(vector_ids, dtype=np.int64).copy()
    total = len(vs)
    assert total > 0
    rng.shuffle(vs)

    device = source.device
    partitions = calculate_partitions(total, bp.order)
    layers: List[Layer] = []
    i = 0
    while i != len(partitions):
        layer_count = len(partitions)
        length = partitions[i]
        level = layer_count - i - 1
        slice_length = min(length, total)
        m = bp.zero_layer_neighborhood_size if level == 0 else bp.neighborhood_size
        with TRACER.span("generate_layer", level=level, nodes=slice_length):
            layer = generate_layer(
                pool_draws(seed, slice_length, slice_length, 5 * m, device),
                torch.as_tensor(vs[:slice_length], dtype=ID_DTYPE, device=device),
                m,
                layers,
                source,
                metric,
                bp.initial_partition_search,
                exact_seed_threshold=bp.exact_seed_threshold,
            )
        layers.append(layer)
        if improver is not None:
            old_count = len(layers)
            layers = improver(layers)
            delta = len(layers) - old_count
            if delta > 0:
                # promotion grew the stack: refresh the ladder (reference:
                # src/lib.rs:879-887)
                suffix = partitions[i + 1 :]
                partitions = [l.node_count for l in layers] + suffix
                i += delta
        i += 1
    return layers
