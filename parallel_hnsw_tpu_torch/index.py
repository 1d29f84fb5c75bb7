"""The Hnsw index: user-facing API tying build/search/optimize/promote together
(counterpart of ``parallel_hnsw_tpu.index``).

API parity with the reference's ``Hnsw<C>`` (src/lib.rs:585-1686): generate,
search[_upto,_instrumented], knn, threshold_nn, improve_index,
improve_neighbors, promote_at_layer, stochastic_recall[_at],
discover_unreachable_vectors, extend_layer, the BFS diagnostics
(node_distances_for_layer, discover_nodes_to_promote,
reachables_from_node_for_layer), plus persistence in
:mod:`parallel_hnsw_tpu_torch.io`.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch import analysis as _analysis
from parallel_hnsw_tpu_torch import build as _build
from parallel_hnsw_tpu_torch import optimize as _optimize
from parallel_hnsw_tpu_torch import promote as _promote
from parallel_hnsw_tpu_torch import routing as _routing
from parallel_hnsw_tpu_torch.analysis import brute_force_knn, fast_flat_knn
from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.graph import (
    DenseSource,
    Layer,
    PqSource,
    Source,
    assert_layer_invariants,
    materialize_source,
    source_get,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.ops.queues import empty_queue
from parallel_hnsw_tpu_torch.params import (
    BuildParams,
    OptimizationParams,
    SearchParams,
    params_to_dict,
)
from parallel_hnsw_tpu_torch.progress import ProgressMonitor, ensure_monitor
from parallel_hnsw_tpu_torch.search import search as _search
from parallel_hnsw_tpu_torch.search import search_instrumented as _search_instrumented
from parallel_hnsw_tpu_torch.search import search_one_layer
from parallel_hnsw_tpu_torch.utils.trace import TRACER


class Hnsw:
    """A layered similarity graph over a vector source.

    ``layers`` are ordered top→bottom like the reference.  Mutation
    (improve/promote/extend) rebinds ``self.layers`` to new tensors.
    """

    def __init__(
        self,
        layers: List[Layer],
        source: Source,
        metric: Metric,
        build_parameters: Optional[BuildParams] = None,
        verbose: bool = False,
    ):
        self.layers = list(layers)
        self.source = source
        self.metric = Metric(metric)
        self.build_parameters = build_parameters or BuildParams()
        self.verbose = verbose
        self._dense_cache: Optional[Tuple[Source, DenseSource]] = None
        self._routing: Optional[_routing.RoutingCache] = None
        self._hop_slabs: Optional[_routing.HopSlabs] = None

    # -- construction --------------------------------------------------------

    @classmethod
    def generate(
        cls,
        source: Source,
        vector_ids=None,
        bp: Optional[BuildParams] = None,
        metric: Metric = Metric.COSINE,
        seed: int = 0,
        improve: bool = True,
        progress: Optional[ProgressMonitor] = None,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
    ) -> "Hnsw":
        """Full ladder build (reference: Hnsw::generate, src/lib.rs:825-893),
        running ``improve_index`` after every layer like the reference, then
        ``bp.final_relink_sweeps`` unconditional relink sweeps.

        ``checkpoint_dir``: persist the stack after every ladder layer (the
        reference only has whole-index persistence; mid-build checkpoints make
        long builds resumable/inspectable).  If the directory already holds a
        partial ladder checkpoint of this build (same seed, corpus size,
        metric and parameters), the build RESUMES from it: the stored stack
        becomes the ladder prefix and only the remaining larger rungs are
        built.  A checkpoint of another build is ignored."""
        # io imports this module
        from parallel_hnsw_tpu_torch.io import deserialize_hnsw, read_index_meta, serialize_hnsw

        bp = bp or BuildParams()
        metric = Metric(metric)
        monitor = ensure_monitor(progress)
        if vector_ids is None:
            vector_ids = np.arange(source.count)
        self_ref = cls([], source, metric, bp, verbose)
        t_start = time.time()

        ckpt_meta = {"build_seed": seed, "corpus_count": int(source.count)}
        initial_layers = None
        if checkpoint_dir is not None and os.path.exists(os.path.join(checkpoint_dir, "meta")):
            meta = read_index_meta(checkpoint_dir)
            compatible = (
                meta.get("build_seed") == seed
                and meta.get("corpus_count") == int(source.count)
                and meta.get("metric") == metric.value
                and meta.get("build_parameters") == params_to_dict(bp)
            )
            if not compatible:
                self_ref._log(
                    "checkpoint is from a different build (seed/corpus/metric/"
                    "params mismatch) — ignoring it and rebuilding from scratch"
                )
            else:
                prev = deserialize_hnsw(checkpoint_dir, source=source)
                if prev.layers and prev.layers[-1].node_count <= source.count:
                    initial_layers = prev.layers
                    self_ref._log(
                        f"resuming from checkpoint: {len(initial_layers)} layers, "
                        f"bottom {initial_layers[-1].node_count}"
                    )

        def improver(layers: List[Layer]) -> List[Layer]:
            monitor.update(
                {
                    "type": "layer_built",
                    "layers": [l.node_count for l in layers],
                    "seconds": round(time.time() - t_start, 1),
                }
            )
            if checkpoint_dir is not None:
                self_ref.layers = layers
                serialize_hnsw(
                    self_ref, checkpoint_dir, store_source=False, extra_meta=ckpt_meta
                )
            if not improve:
                return layers
            monitor.alive()
            self_ref.layers = layers
            with monitor.keep_alive():  # scope guard, reference: keepalive!
                with TRACER.span("improve_index", layers=len(layers)):
                    recall = self_ref.improve_index(bp, progress=monitor)
            monitor.update(
                {
                    "type": "improved",
                    "recall": recall,
                    "seconds": round(time.time() - t_start, 1),
                }
            )
            return self_ref.layers

        build_source = self_ref.compute_source  # densified for PQ (same distances)
        self_ref.layers = _build.generate(
            build_source, vector_ids, bp, metric, seed, improver, initial_layers=initial_layers
        )
        if improve and bp.final_relink_sweeps > 0:
            for _ in range(bp.final_relink_sweeps):
                monitor.alive()
                with TRACER.span("final_relink_sweep"):
                    for lft in range(self_ref.layer_count):
                        self_ref.layers, _, _ = _optimize.link_layer_to_better_neighbors(
                            self_ref.layers, lft, build_source, metric,
                            bp.optimization.search,
                            exact_threshold=bp.optimization.exact_relink_threshold,
                            fast_threshold=bp.optimization.fast_relink_threshold,
                        )
            monitor.update(
                {"type": "final_relink", "seconds": round(time.time() - t_start, 1)}
            )
        if checkpoint_dir is not None:
            serialize_hnsw(self_ref, checkpoint_dir, store_source=False, extra_meta=ckpt_meta)
        return self_ref

    # Densified compute cache: PQ reconstruction is deterministic, so when
    # the decoded corpus fits the budget every compute phase runs against a
    # dense copy, with identical distances and one row per candidate instead
    # of 1 + nsub gathered rows.  The JAX package's value, sized for a 16 GB
    # TPU and not measured again on the card; an instance may set its own.
    DENSIFY_BUDGET_BYTES = 4 << 30

    @property
    def compute_source(self) -> Source:
        """The source every compute phase runs against: a PqSource whose
        dense copy fits ``DENSIFY_BUDGET_BYTES`` is densified once (in row
        blocks) and cached; any other source is itself."""
        source = self.source
        if not isinstance(source, PqSource):
            return source
        if source.count * source.dim * 4 > self.DENSIFY_BUDGET_BYTES:
            return source
        if self._dense_cache is None or self._dense_cache[0] is not source:
            self._dense_cache = (source, DenseSource(vectors=materialize_source(source)))
        return self._dense_cache[1]

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[hnsw] {msg}", flush=True)

    # -- accessors (reference: src/lib.rs:591-651) ---------------------------

    @property
    def layer_count(self) -> int:
        return len(self.layers)

    def get_layer(self, i: int) -> Optional[Layer]:
        """i counts from the bottom (reference: get_layer, src/lib.rs:604-606)."""
        return self.get_layer_from_top(self.layer_count - i - 1)

    def get_layer_from_top(self, i: int) -> Optional[Layer]:
        return self.layers[i] if 0 <= i < self.layer_count else None

    @property
    def vector_count(self) -> int:
        return self.layers[-1].node_count if self.layers else 0

    def __len__(self) -> int:
        return self.vector_count

    @property
    def entry_vector(self) -> int:
        return int(self.layers[0].nodes[0])

    def all_vectors(self) -> np.ndarray:
        return self.layers[-1].nodes.cpu().numpy()

    def supers_for_layer(self, layer_id: int) -> np.ndarray:
        """reference: supers_for_layer (src/lib.rs:977-984); layer_id from bottom."""
        if self.layer_count == layer_id + 1:
            return self.get_layer(layer_id).nodes[:1].cpu().numpy()
        return self.get_layer(layer_id + 1).nodes.cpu().numpy()

    # -- search --------------------------------------------------------------

    def enable_routing(self, dr: Optional[int] = 64, seed: int = 0) -> None:
        """Build a routing cache for accelerated traversal (see
        :mod:`parallel_hnsw_tpu_torch.routing`): hops score against narrow bf16
        rows; :meth:`search` restores exact ranking with a full-precision
        rerank.  Derived state — recompute after deserialization."""
        self._routing = _routing.build_routing(
            self.compute_source, self.metric, dr=dr, seed=seed
        )

    def disable_routing(self) -> None:
        self._routing = None

    def enable_hop_slabs(self, byte_budget: int = 4 << 30) -> None:
        """Materialize neighbor-major feature slabs so each hop gathers one
        long row per expanded node instead of M per-candidate rows (see
        :class:`parallel_hnsw_tpu_torch.routing.HopSlabs`).  Built over the
        routing cache when :meth:`enable_routing` ran first (bf16/projected
        rows — the memory knob), else over the full-precision source
        (results identical to the plain hop).  Derived state: any graph
        mutation (improve/promote/extend) drops it — call again after."""
        self._hop_slabs = _routing.build_hop_slabs(
            self.layers, self.compute_source, self.metric,
            routing=self._routing, byte_budget=byte_budget,
        )

    def disable_hop_slabs(self) -> None:
        self._hop_slabs = None

    def _invalidate_hop_slabs(self) -> None:
        self._hop_slabs = None

    def search(
        self,
        queries: torch.Tensor,
        sp: Optional[SearchParams] = None,
        exclude: Optional[torch.Tensor] = None,
        query_block: int = 0,
        routed: Optional[bool] = None,
        rerank_routed: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched multi-layer search. ``queries [Q, D]`` →
        ``(vector_ids [Q, ef], dists [Q, ef])``.

        ``routed`` selects traversal over the routing cache (default: use it
        whenever :meth:`enable_routing` built one); ``rerank_routed=False``
        skips the final exact rerank (for callers that rerank themselves) —
        routed distances are then approximate.
        """
        sp = sp or self.build_parameters.optimization.search
        if routed is None:
            routed = self._routing is not None
        slabs = self._hop_slabs.slabs if self._hop_slabs is not None else None
        if routed and self._routing is not None:
            cache = self._routing
            rq = _routing.route_queries(cache, queries, self.metric)
            ids, dists = _search(
                self.layers, DenseSource(vectors=cache.rows), cache.metric,
                rq, sp, exclude, query_block,
                slabs=slabs if (slabs and self._hop_slabs.routed) else None,
            )
            if not rerank_routed:
                return ids, dists
            return _routing.exact_rerank(self.compute_source, self.metric, queries, ids)
        if slabs is not None and self._hop_slabs.routed:
            slabs = None  # routed-space slabs can't score raw queries
        return _search(
            self.layers, self.compute_source, self.metric, queries, sp, exclude,
            query_block, slabs=slabs,
        )

    def search_instrumented(
        self,
        queries: torch.Tensor,
        sp: Optional[SearchParams] = None,
        exclude: Optional[torch.Tensor] = None,
    ):
        """Batched search returning (ids, dists, stats) with hop counts,
        distance-eval counts and per-query last-improvement hop (reference:
        Hnsw::search_instrumented, src/lib.rs:667-673)."""
        sp = sp or self.build_parameters.optimization.search
        return _search_instrumented(
            self.layers, self.compute_source, self.metric, queries, sp, exclude
        )

    def search_upto(
        self,
        queries: torch.Tensor,
        sp: Optional[SearchParams] = None,
        upto_layer_from_top: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search only the top ``upto_layer_from_top`` layers of the stack
        (reference: Hnsw::search_upto, src/lib.rs:654-661 — searches
        ``layers[..upto_layer_from_top]``).

        ``upto_layer_from_top`` must be in ``[1, layer_count]``; ``None``
        (default) searches the full stack, same as :meth:`search`.  The
        reference's 0 case indexes an empty slice and panics
        (src/search.rs:9-11); here it raises ``ValueError`` instead.
        """
        sp = sp or self.build_parameters.optimization.search
        if upto_layer_from_top is None:
            upto_layer_from_top = len(self.layers)
        if not 1 <= upto_layer_from_top <= len(self.layers):
            raise ValueError(
                f"upto_layer_from_top must be in [1, {len(self.layers)}], "
                f"got {upto_layer_from_top} (0 layers has no entry point)"
            )
        return _search(
            self.layers[:upto_layer_from_top], self.compute_source, self.metric, queries, sp
        )

    def search_exact(
        self,
        queries: torch.Tensor,
        k: int = 10,
        query_block: int = 4096,
        fast: bool = False,
        oversample: int = 4,
    ):
        """Exact top-k by a full blocked scan (no graph traversal), through
        the pairwise-distance kernel on a CUDA source.

        ``fast=True`` is the flat scan of :func:`analysis.fast_flat_knn`: a
        fast-precision pass (the binned or folded scan kernel from 200k rows
        up) that keeps ``oversample * k`` survivors, then a full-precision
        rerank restores exact ordering before the cut to ``k``."""
        if fast:
            return fast_flat_knn(
                self.compute_source, queries, self.metric, k, oversample, query_block
            )
        return brute_force_knn(self.compute_source, queries, self.metric, k, query_block)

    def search_ids(self, vector_ids, sp=None, exclude_self: bool = False):
        """Search with stored vectors as queries (AbstractVector::Stored)."""
        vector_ids = torch.as_tensor(vector_ids, dtype=ID_DTYPE, device=self.source.device)
        queries = source_get(self.compute_source, vector_ids)
        exclude = vector_ids if exclude_self else None
        return self.search(queries, sp, exclude=exclude)

    # -- self-similarity (reference: knn/threshold_nn, src/lib.rs:905-962) ---

    def knn(
        self, k: int, probe_depth: int = 2, query_block: int = 0
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All-pairs k-nearest-neighbors over the bottom layer.

        Returns ``(vector_ids [N], neighbor_ids [N, k], dists [N, k])`` as
        numpy arrays, like the JAX package.
        """
        layer = self.layers[-1]
        n = layer.node_count
        cap = k * 3
        sp = SearchParams(
            number_of_candidates=cap,
            upper_layer_candidate_count=cap,
            probe_depth=probe_depth,
        )
        dev = layer.nodes.device
        block = query_block if query_block > 0 else n
        found = [
            self._bottom_layer_self_search_idx(
                torch.arange(start, min(start + block, n), device=dev), cap, sp
            )
            for start in range(0, n, block)
        ]
        node_ids = torch.cat([f[0] for f in found])
        dists = torch.cat([f[1] for f in found])
        # drop self, take k (reference: src/lib.rs:920-925)
        return self._finish_self_search(node_ids, dists, None, k)

    def _finish_self_search(
        self, node_ids: torch.Tensor, dists: torch.Tensor, threshold: Optional[float], k: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Mask each row's own node (and entries at or beyond ``threshold``),
        re-sort stably by distance, cut to ``k`` columns and map node ids to
        vector ids; the results go to the host as numpy arrays."""
        nodes = self.layers[-1].nodes
        n = nodes.shape[0]
        bad = node_ids == torch.arange(n, device=nodes.device)[:, None]
        if threshold is not None:
            bad = bad | (dists >= threshold)
        dists = torch.where(bad, EMPTY_DIST, dists)
        node_ids = torch.where(bad, EMPTY_ID, node_ids)
        dists, order = torch.sort(dists, dim=-1, stable=True)
        node_ids = torch.gather(node_ids, -1, order)[:, :k]
        vec_ids = torch.where(
            node_ids == EMPTY_ID, EMPTY_ID, nodes[torch.clamp(node_ids, 0, n - 1).long()]
        )
        return nodes.cpu().numpy(), vec_ids.cpu().numpy(), dists[:, :k].cpu().numpy()

    def _bottom_layer_self_search_idx(
        self, node_idx: torch.Tensor, cap: int, sp: SearchParams
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Self-search of the given bottom-layer node indices at queue
        capacity ``cap``: ``(node_ids [B, cap], dists [B, cap])`` on the
        device.  (The JAX package pads the batch to a query bucket to reuse
        compiled programs; nothing is compiled here.)"""
        layer = self.layers[-1]
        idx = node_idx.to(ID_DTYPE)
        queries = source_get(self.compute_source, layer.nodes[idx.long()])
        init_ids, init_dists = empty_queue(cap, (idx.shape[0],), device=idx.device)
        init_ids[:, 0] = idx
        init_dists[:, 0] = 0.0
        state = search_one_layer(
            layer, self.compute_source, self.metric, queries, init_ids, init_dists,
            probe_depth=sp.probe_depth, beam_width=sp.beam_width, max_hops=sp.max_hops,
        )
        return state.ids, state.dists

    def threshold_nn(
        self,
        threshold: float,
        probe_depth: int = 2,
        initial_search_depth: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All neighbors within ``threshold`` distance, growing the queue by
        doubling until covered (reference: threshold_nn, src/lib.rs:930-962).

        Returns ``(vector_ids [N], neighbor_ids [N, cap], dists [N, cap])``
        as numpy arrays, where entries at distance >= threshold are
        EMPTY-padded.  The ``[N, max_cap]`` assembly stays on the device
        until the end.
        """
        layer = self.layers[-1]
        n = layer.node_count
        dev = layer.nodes.device
        cap = initial_search_depth or self.build_parameters.zero_layer_neighborhood_size
        sp = SearchParams(probe_depth=probe_depth)
        # per-node doubling (reference semantics, src/lib.rs:946-952): nodes
        # whose queue already covers the threshold retire each round; only the
        # uncovered remainder re-searches at doubled capacity, so one dense
        # straggler never forces a whole-corpus re-scan.
        active = torch.arange(n, device=dev)
        done_rounds = []  # (node_idx, node_ids, dists) per retired batch
        while True:
            ids_r, d_r = self._bottom_layer_self_search_idx(
                active, cap,
                sp.replace(number_of_candidates=cap, upper_layer_candidate_count=cap),
            )
            finite = torch.isfinite(d_r)
            last = torch.where(
                finite.any(-1),
                torch.amax(torch.where(finite, d_r, -EMPTY_DIST), dim=-1),
                0.0,
            )
            uncovered = (last < threshold) & finite.all(dim=-1)
            keep = (~uncovered).nonzero()[:, 0]
            if keep.numel():
                done_rounds.append((active[keep], ids_r[keep], d_r[keep]))
            active = active[uncovered.nonzero()[:, 0]]
            if active.numel() == 0:
                break
            cap *= 2
        # assemble at the widest capacity reached
        max_cap = max(r[1].shape[1] for r in done_rounds)
        node_ids = torch.full((n, max_cap), EMPTY_ID, dtype=ID_DTYPE, device=dev)
        dists = torch.full((n, max_cap), EMPTY_DIST, dtype=torch.float32, device=dev)
        for idx, ids_r, d_r in done_rounds:
            node_ids[idx, : ids_r.shape[1]] = ids_r
            dists[idx, : d_r.shape[1]] = d_r
        return self._finish_self_search(node_ids, dists, threshold, max_cap)

    # -- optimization (reference: src/lib.rs:1463-1686) ----------------------

    def stochastic_recall_at(self, at: int, op: Optional[OptimizationParams] = None) -> float:
        op = op or self.build_parameters.optimization
        return _optimize.stochastic_recall_at(
            self.layers, at, self.compute_source, self.metric, op
        )

    def stochastic_recall(self, op: Optional[OptimizationParams] = None) -> float:
        op = op or self.build_parameters.optimization
        return _optimize.stochastic_recall(self.layers, self.compute_source, self.metric, op)

    def improve_neighbors(
        self,
        op: Optional[OptimizationParams] = None,
        last_recall: Optional[float] = None,
        progress: Optional[ProgressMonitor] = None,
    ) -> float:
        op = op or self.build_parameters.optimization
        self.layers, recall = _optimize.improve_neighbors(
            self.layers, self.compute_source, self.metric, op, last_recall, monitor=progress
        )
        self._invalidate_hop_slabs()
        return recall

    def _promoter(self, layers: List[Layer], lft: int, bp: BuildParams, monitor=None):
        def generate_fn(vecs: np.ndarray, new_bp: BuildParams) -> List[Layer]:
            # the ephemeral top-stack rebuild runs on the densified compute
            # source directly (only its layers are spliced back)
            sub = Hnsw.generate(
                self.compute_source, vecs, new_bp, self.metric, improve=True,
                verbose=self.verbose,
            )
            return sub.layers

        return _promote.promote_at_layer(
            layers, lft, bp, self.compute_source, self.metric, generate_fn,
            log=self._log if self.verbose else None, monitor=monitor,
        )

    def promote_at_layer(self, layer_from_top: int, bp: Optional[BuildParams] = None) -> bool:
        bp = bp or self.build_parameters
        self.layers, promoted = self._promoter(self.layers, layer_from_top, bp)
        self._invalidate_hop_slabs()
        return promoted

    def improve_index(
        self,
        bp: Optional[BuildParams] = None,
        last_recall: Optional[float] = None,
        progress: Optional[ProgressMonitor] = None,
    ) -> float:
        bp = bp or self.build_parameters
        monitor = ensure_monitor(progress)

        def promoter(layers, lft, bpp):
            monitor.alive()
            return self._promoter(layers, lft, bpp, monitor=monitor)

        self.layers, recall = _optimize.improve_index(
            self.layers,
            bp,
            self.compute_source,
            self.metric,
            last_recall,
            promoter,
            log=self._log if self.verbose else None,
            monitor=monitor,
        )
        self._invalidate_hop_slabs()
        return recall

    # -- diagnostics (reference: src/lib.rs:279-548, 977-1000) ---------------

    def node_distances_for_layer(self, layer_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """BFS (hops, index_sum) per node of a from-bottom layer id
        (reference: node_distances_for_layer, src/lib.rs:986-990)."""
        return _analysis.node_distances(self.get_layer(layer_id), self.supers_for_layer(layer_id))

    def discover_nodes_to_promote(self, layer_id: int) -> np.ndarray:
        return _analysis.discover_nodes_to_promote(
            self.get_layer(layer_id), self.supers_for_layer(layer_id)
        )

    def reachables_from_node_for_layer(self, layer_id_from_top: int, node: int, check):
        return _analysis.reachables_from(self.layers[layer_id_from_top], node, check)

    # -- repair plumbing -----------------------------------------------------

    def discover_unreachable_vectors(
        self, layer_id_from_top: int, sp: Optional[SearchParams] = None
    ) -> np.ndarray:
        sp = sp or self.build_parameters.optimization.search
        return _promote.discover_unreachable_vectors(
            self.layers, layer_id_from_top, self.compute_source, self.metric, sp
        )

    def extend_layer(self, layer_id: int, vecs: np.ndarray) -> None:
        self.layers = _promote.extend_layer(self.layers, layer_id, vecs)
        self._invalidate_hop_slabs()

    def assert_invariants(self) -> None:
        assert_layer_invariants(self.layers)
