"""The Hnsw index: user-facing API tying build/search/optimize/promote together
(counterpart of the dense part of ``parallel_hnsw_tpu.index``).

API parity with the reference's ``Hnsw<C>`` (src/lib.rs:585-1686): generate,
search, improve_index, improve_neighbors, promote_at_layer,
stochastic_recall[_at], discover_unreachable_vectors, extend_layer.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch import build as _build
from parallel_hnsw_tpu_torch import optimize as _optimize
from parallel_hnsw_tpu_torch import promote as _promote
from parallel_hnsw_tpu_torch.analysis import brute_force_knn
from parallel_hnsw_tpu_torch.constants import ID_DTYPE
from parallel_hnsw_tpu_torch.graph import Layer, Source, assert_layer_invariants, source_get
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw_tpu_torch.progress import ProgressMonitor, ensure_monitor
from parallel_hnsw_tpu_torch.search import search as _search
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
    ) -> "Hnsw":
        """Full ladder build (reference: Hnsw::generate, src/lib.rs:825-893),
        running ``improve_index`` after every layer like the reference, then
        ``bp.final_relink_sweeps`` unconditional relink sweeps."""
        bp = bp or BuildParams()
        metric = Metric(metric)
        monitor = ensure_monitor(progress)
        if vector_ids is None:
            vector_ids = np.arange(source.count)
        self_ref = cls([], source, metric, bp, verbose)
        t_start = time.time()

        def improver(layers: List[Layer]) -> List[Layer]:
            monitor.update(
                {
                    "type": "layer_built",
                    "layers": [l.node_count for l in layers],
                    "seconds": round(time.time() - t_start, 1),
                }
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

        self_ref.layers = _build.generate(source, vector_ids, bp, metric, seed, improver)
        if improve and bp.final_relink_sweeps > 0:
            for _ in range(bp.final_relink_sweeps):
                monitor.alive()
                with TRACER.span("final_relink_sweep"):
                    for lft in range(self_ref.layer_count):
                        self_ref.layers, _, _ = _optimize.link_layer_to_better_neighbors(
                            self_ref.layers, lft, source, metric,
                            bp.optimization.search,
                            exact_threshold=bp.optimization.exact_relink_threshold,
                            fast_threshold=bp.optimization.fast_relink_threshold,
                        )
            monitor.update(
                {"type": "final_relink", "seconds": round(time.time() - t_start, 1)}
            )
        return self_ref

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

    def search(
        self,
        queries: torch.Tensor,
        sp: Optional[SearchParams] = None,
        exclude: Optional[torch.Tensor] = None,
        query_block: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched multi-layer search. ``queries [Q, D]`` →
        ``(vector_ids [Q, ef], dists [Q, ef])``."""
        sp = sp or self.build_parameters.optimization.search
        return _search(
            self.layers, self.source, self.metric, queries, sp, exclude, query_block
        )

    def search_exact(self, queries: torch.Tensor, k: int = 10, query_block: int = 4096):
        """Exact top-k by a full blocked scan (no graph traversal), through
        the pairwise-distance kernel on a CUDA source."""
        return brute_force_knn(self.source, queries, self.metric, k, query_block)

    def search_ids(self, vector_ids, sp=None, exclude_self: bool = False):
        """Search with stored vectors as queries (AbstractVector::Stored)."""
        vector_ids = torch.as_tensor(vector_ids, dtype=ID_DTYPE, device=self.source.device)
        queries = source_get(self.source, vector_ids)
        exclude = vector_ids if exclude_self else None
        return self.search(queries, sp, exclude=exclude)

    # -- optimization (reference: src/lib.rs:1463-1686) ----------------------

    def stochastic_recall_at(self, at: int, op: Optional[OptimizationParams] = None) -> float:
        op = op or self.build_parameters.optimization
        return _optimize.stochastic_recall_at(self.layers, at, self.source, self.metric, op)

    def stochastic_recall(self, op: Optional[OptimizationParams] = None) -> float:
        op = op or self.build_parameters.optimization
        return _optimize.stochastic_recall(self.layers, self.source, self.metric, op)

    def improve_neighbors(
        self,
        op: Optional[OptimizationParams] = None,
        last_recall: Optional[float] = None,
        progress: Optional[ProgressMonitor] = None,
    ) -> float:
        op = op or self.build_parameters.optimization
        self.layers, recall = _optimize.improve_neighbors(
            self.layers, self.source, self.metric, op, last_recall, monitor=progress
        )
        return recall

    def _promoter(self, layers: List[Layer], lft: int, bp: BuildParams, monitor=None):
        def generate_fn(vecs: np.ndarray, new_bp: BuildParams) -> List[Layer]:
            sub = Hnsw.generate(
                self.source, vecs, new_bp, self.metric, improve=True, verbose=self.verbose
            )
            return sub.layers

        return _promote.promote_at_layer(
            layers, lft, bp, self.source, self.metric, generate_fn,
            log=self._log if self.verbose else None, monitor=monitor,
        )

    def promote_at_layer(self, layer_from_top: int, bp: Optional[BuildParams] = None) -> bool:
        bp = bp or self.build_parameters
        self.layers, promoted = self._promoter(self.layers, layer_from_top, bp)
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
            self.source,
            self.metric,
            last_recall,
            promoter,
            log=self._log if self.verbose else None,
            monitor=monitor,
        )
        return recall

    # -- repair plumbing -----------------------------------------------------

    def discover_unreachable_vectors(
        self, layer_id_from_top: int, sp: Optional[SearchParams] = None
    ) -> np.ndarray:
        sp = sp or self.build_parameters.optimization.search
        return _promote.discover_unreachable_vectors(
            self.layers, layer_id_from_top, self.source, self.metric, sp
        )

    def extend_layer(self, layer_id: int, vecs: np.ndarray) -> None:
        self.layers = _promote.extend_layer(self.layers, layer_id, vecs)

    def assert_invariants(self) -> None:
        assert_layer_invariants(self.layers)
