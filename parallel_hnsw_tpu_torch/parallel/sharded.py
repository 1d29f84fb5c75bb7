"""Sharded indexes over a mesh of devices (counterpart of
``parallel_hnsw_tpu.parallel.sharded``).

The scale-out axis is corpus size: the corpus is split round-robin over the
shards of a :class:`Mesh`, each shard owns a full HNSW over its rows (or,
scan-only, just its rows) on its own device, and a query fans out to every
shard's search followed by a cross-shard top-k merge.  No cross-shard
pointer ever exists, so the shards exchange one ``[Q, k]`` queue each per
query batch.  Dense and PQ-compressed shards are supported; the PQ index
keeps its full-precision rows either on the shards' devices (in core) or on
the host in a :class:`~parallel_hnsw_tpu_torch.graph.MemmapSource` (out of
core: only codes live on the devices).  This is the layout of the JAX
package's 100M x 768-d PQ-sharded configuration.

The JAX module is one SPMD program over local devices: ``shard_map`` runs
the per-shard function and ``all_gather`` merges.  Here it is one process
too, with no process group: the per-shard function runs for each shard in
turn, on the shard's device, and the merge moves each shard's ``[Q, k]``
queue to the mesh's first device, concatenates them in shard order and
sorts.  A mesh may name one device several times: S shards on one card
share it, as the CPU tests run 8 shards on ``cpu``.  Shard builds and
out-of-core ingestion run in shard order on the calling thread (the JAX
package overlaps them on one host thread per device); a shard's graph
depends on ``seed + s`` alone.  ``parallel_build`` / ``parallel`` are taken
for the JAX package's signatures and change nothing.

Each shard's state is a plain :class:`~parallel_hnsw_tpu_torch.index.Hnsw`
whose layers are padded to the widest shard's shapes (``EMPTY_ID`` nodes and
neighbors), so ``layers_stacked`` / ``source_stacked`` / ``global_ids``
stack exactly as the JAX package's arrays do.

Divergences from the JAX package, by design: ``approx_min_k`` is an exact
``torch.topk`` re-sorted by ``(dist, id)``; the in-shard reranks against
dense rows (a dense shard, in-core PQ full vectors) are one
``gather_distance`` launch through ``graph.source_distance`` (JAX: a gather
and ``batched_distance``, the same function); a code-graph search hops over
each shard's densified codes while they fit ``Hnsw.DENSIFY_BUDGET_BYTES``,
as a single ``QuantizedHnsw`` does (the same distances).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise
from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.flat import block_scan, blocked_scan, exact_rerank
from parallel_hnsw_tpu_torch.graph import (
    DenseSource,
    Layer,
    PqSource,
    Source,
    host_rows,
    is_host_source,
    narrow_codes,
    reconstruct,
    source_distance,
    source_get,
)
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.io import from_numpy, to_numpy
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.ops.queues import dedup_sorted, sort_queue
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams, PqBuildParams, SearchParams
from parallel_hnsw_tpu_torch.pq import (
    HnswQuantizer,
    SubspaceQuantizer,
    code_dtype_for,
    kmeans_centroids,
    per_subspace_centroids,
    quantize_binned,
    random_centroids,
)
from parallel_hnsw_tpu_torch.search import search as graph_search
from parallel_hnsw_tpu_torch.utils.trace import TRACER


class Mesh:
    """A one-axis device mesh: one ``torch.device`` per shard, and the axis
    name.  ``devices`` is a numpy object array, so ``mesh.devices.size``,
    ``mesh.devices.flat`` and ``mesh.axis_names[0]`` read as they do on a
    ``jax.sharding.Mesh``.  A device may appear several times (several shards
    on one card)."""

    def __init__(self, devices: Sequence, axis: str = "shard"):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = d
        self.axis_names = (axis,)

    @property
    def first(self) -> torch.device:
        """Where merged results land (the JAX merge's replicated output)."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices.flat]}, axis={self.axis_names[0]!r})"


def default_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    """A mesh over the local CUDA devices (the first ``n_devices`` of them),
    as the JAX package's takes ``jax.devices()``.  Shards that share a card,
    or the CPU, take an explicit :class:`Mesh`: ``Mesh(["cuda:0"] * 4)``."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError("no CUDA device for a default mesh; pass Mesh([...]) explicitly")
    return Mesh(devs, axis)


def _on(device: torch.device):
    """Make ``device`` the thread's current CUDA device (nothing for a CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _for_each_shard(fn: Callable[[int], object], devices: Sequence[torch.device]) -> list:
    """``[fn(s) for s in shards]``, in shard order on the calling thread.

    The JAX package overlaps shard builds on one host thread per device.
    The port runs them in turn: its meshes name one device several times
    (4 shards of one card, 8 of the CPU), and a threaded path for shards on
    distinct cards is left until it can be run and tested on such a host."""
    return [fn(s) for s in range(len(devices))]


def _partition(count: int, n_shards: int) -> Tuple[List[np.ndarray], np.ndarray]:
    """Round-robin rows of each shard, a ragged shard padded by repeating its
    last row, and the ``[S, per]`` global ids (``EMPTY_ID`` on padding)."""
    per = -(-count // n_shards)
    gids = np.full((n_shards, per), EMPTY_ID, np.int32)
    rows = []
    for s in range(n_shards):
        ids = np.arange(s, count, n_shards)
        real = len(ids)
        if per - real:
            ids = np.concatenate([ids, np.repeat(ids[-1:], per - real)])
        gids[s, :real] = ids[:real]
        rows.append(ids)
    return rows, gids


def _take_rows(table: torch.Tensor, ids: np.ndarray, device: torch.device) -> torch.Tensor:
    """Rows ``ids`` of ``table`` on ``device`` (``uint16`` through int16)."""
    idx = torch.as_tensor(ids, dtype=torch.int64, device=table.device)
    if table.dtype == torch.uint16:
        return _tensor(table.view(torch.int16)[idx].view(torch.uint16), device)
    return table[idx].to(device)


def _take_rows_source(source: Source, ids: np.ndarray, device: torch.device) -> Source:
    if isinstance(source, DenseSource):
        return DenseSource(vectors=_take_rows(source.vectors, ids, device))
    if isinstance(source, PqSource):
        return PqSource(codes=_take_rows(source.codes, ids, device),
                        codebook=source.codebook.to(device))
    raise TypeError(f"a sharded index takes a device source, got {type(source).__name__}")


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor or numpy array on ``device``; ``uint16`` through its int16
    bits (torch copies few ``uint16`` tensors between devices)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        return from_numpy(x if x.flags.writeable else x.copy(), device)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(device).view(torch.uint16)
    return x.to(device)


def _source_to(source: Source, device: torch.device) -> Source:
    return type(source)(*(_tensor(t, device) for t in source))


def _stack(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    if tensors[0].dtype == torch.uint16:
        return torch.stack([_tensor(t, device).view(torch.int16) for t in tensors]).view(torch.uint16)
    return torch.stack([t.to(device) for t in tensors])


def _shard_rows(local: Source, start: int, stop: int) -> torch.Tensor:
    """Rows ``[start, stop)`` of a shard's source as f32: a dense shard's
    slice, a PQ shard's codes reconstructed."""
    if isinstance(local, DenseSource):
        return local.vectors[start:stop]
    if isinstance(local, PqSource):
        return reconstruct(local.codebook, local.codes[start:stop])
    raise TypeError(f"a shard's source is a device source, got {type(local).__name__}")


def _shard_flat_scan(local: Source, queries: torch.Tensor, metric: Metric, k_scan: int,
                     fast: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's blocked flat scan over its local source, all its queries
    at once, by :func:`~parallel_hnsw_tpu_torch.flat.block_scan`'s kernel
    and blocks.  Returns ``(best_i, best_d)``: local row ids and
    scan-precision distances, ``k_scan`` wide, sorted by ``(dist, id)``."""
    mode, block = block_scan(local.count, fast)
    return blocked_scan(queries, lambda start, stop: _shard_rows(local, start, stop), local.count,
                        metric, mode, k_scan, block, max(1, queries.shape[0]))


def _merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int, device: torch.device,
           dedup: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard merge (JAX: ``all_gather`` over the mesh axis): each
    shard's ``[Q, k]`` queue to ``device``, concatenated in shard order,
    sorted by ``(dist, id)`` (and deduplicated: padding rows repeat real
    ids), cut to ``k``."""
    ids = torch.cat([p[0].to(device) for p in parts], dim=1)
    dists = torch.cat([p[1].to(device) for p in parts], dim=1)
    ids, dists = sort_queue(ids, dists)
    if dedup:
        ids, dists = dedup_sorted(ids, dists)
    return ids[:, :k], dists[:, :k]


class ShardedHnsw:
    """A corpus sharded over a mesh axis, one HNSW per shard.

    ``layers_stacked``: per ladder level, (nodes [S, N], neighbors [S, N, M]).
    ``source_stacked``: shard-major vector source (dense [S, N, D] or PQ codes
    [S, N, Q] + a shared codebook); ``global_ids``: [S, N] mapping local ids
    to corpus ids (EMPTY_ID on padding rows).  Tensors or numpy arrays; each
    shard's slice is placed on its mesh device.
    """

    def __init__(
        self,
        mesh: Mesh,
        layers_stacked: Sequence[Layer],
        source_stacked: Source,
        global_ids,
        metric: Metric,
        build_parameters: Optional[BuildParams] = None,
    ):
        n = mesh.devices.size
        if isinstance(source_stacked, DenseSource):
            sources = [DenseSource(vectors=source_stacked.vectors[s]) for s in range(n)]
        elif isinstance(source_stacked, PqSource):
            sources = [PqSource(codes=source_stacked.codes[s], codebook=source_stacked.codebook)
                       for s in range(n)]
        else:
            raise TypeError(f"a sharded index takes a device source, got {type(source_stacked)}")
        self._init(
            mesh,
            [[Layer(l.nodes[s], l.neighbors[s]) for l in layers_stacked] for s in range(n)],
            sources, [global_ids[s] for s in range(n)], metric, build_parameters,
        )

    def _init(self, mesh, shard_layers, shard_sources, shard_gids, metric, build_parameters):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.metric = Metric(metric)
        self.build_parameters = build_parameters or BuildParams()
        devices = list(mesh.devices.flat)
        if len(shard_sources) != len(devices):
            raise ValueError(f"{len(shard_sources)} shards on a mesh of {len(devices)} devices")
        # one Hnsw per shard over its padded layers; it caches the densified
        # copy of a PQ shard for the code-graph hop (compute_source)
        self._shards: List[Hnsw] = []
        self._gids: List[torch.Tensor] = []
        for s, dev in enumerate(devices):
            source = _source_to(shard_sources[s], dev)
            layers = [Layer(_tensor(l.nodes, dev), _tensor(l.neighbors, dev))
                      for l in shard_layers[s]]
            self._shards.append(Hnsw(layers, source, self.metric, self.build_parameters))
            self._gids.append(_tensor(shard_gids[s], dev).to(ID_DTYPE))

    @classmethod
    def _from_shards(cls, mesh, shard_layers, shard_sources, shard_gids, metric, bp):
        out = cls.__new__(cls)
        out._init(mesh, shard_layers, shard_sources, shard_gids, metric, bp)
        return out

    # -- construction --------------------------------------------------------

    @classmethod
    def generate(
        cls,
        source: Source,
        mesh: Mesh,
        bp: Optional[BuildParams] = None,
        metric: Metric = Metric.COSINE,
        seed: int = 0,
        improve: bool = True,
        verbose: bool = False,
        parallel_build: bool = True,
        build_graphs: bool = True,
    ) -> "ShardedHnsw":
        """Partition the corpus round-robin over shards (a ragged shard is
        padded by repeating its last row; padding rows get EMPTY global ids
        and are masked from results) and build one HNSW per shard on its own
        device (:meth:`from_shard_sources`)."""
        devices = list(mesh.devices.flat)
        rows, shard_gids = _partition(source.count, len(devices))
        shard_sources = [_take_rows_source(source, rows[s], dev) for s, dev in enumerate(devices)]
        return cls.from_shard_sources(
            shard_sources, shard_gids, mesh, bp, metric, seed=seed, improve=improve,
            verbose=verbose, parallel_build=parallel_build, build_graphs=build_graphs,
        )

    @classmethod
    def from_shard_sources(
        cls,
        shard_sources: Sequence[Source],
        shard_gids: np.ndarray,  # [S, per] global ids, EMPTY_ID on padding
        mesh: Mesh,
        bp: Optional[BuildParams] = None,
        metric: Metric = Metric.COSINE,
        seed: int = 0,
        improve: bool = True,
        verbose: bool = False,
        parallel_build: bool = True,
        build_graphs: bool = True,
    ) -> "ShardedHnsw":
        """Build one HNSW per pre-partitioned shard source on its mesh device
        (``Hnsw.generate`` with ``seed + s``), equalize the ladders by
        replicating a shorter shard's top level, and pad every level to the
        widest shard's node and neighbor counts.

        ``build_graphs=False`` gives a **scan-only** index: the shard sources
        are placed and no graph is built; :meth:`search_exact` is its only
        query engine (the serving shape of the 100M PQ-sharded
        configuration, whose engine is the flat code scan)."""
        bp = bp or BuildParams()
        metric = Metric(metric)
        devices = list(mesh.devices.flat)
        if len(shard_sources) != len(devices):
            raise ValueError(f"{len(shard_sources)} shard sources for {len(devices)} devices")
        shard_sources = [_source_to(src, dev) for src, dev in zip(shard_sources, devices)]
        if not build_graphs:
            return cls._from_shards(mesh, [[] for _ in devices], shard_sources, shard_gids,
                                    metric, bp)

        def build_one(s: int) -> Hnsw:
            # local ids 0..real (padding rows duplicate the last real row:
            # never graph members, masked at query time)
            real = int((np.asarray(shard_gids[s]) != EMPTY_ID).sum())
            with _on(devices[s]):
                return Hnsw.generate(shard_sources[s], np.arange(real), bp, metric,
                                     seed=seed + s, improve=improve, verbose=verbose)

        hnsws = _for_each_shard(build_one, devices)
        out = cls._from_shards(mesh, [[] for _ in devices], shard_sources, shard_gids, metric, bp)
        for h, built in zip(out._shards, hnsws):
            h._dense_cache = built._dense_cache  # a PQ shard's densified copy, if any
        out._restack_from_hnsws(hnsws)
        return out

    def place(self) -> None:
        """Put every shard's tensors on its mesh device."""
        for h, dev in zip(self._shards, self.mesh.devices.flat):
            h.layers = [Layer(l.nodes.to(dev), l.neighbors.to(dev)) for l in h.layers]
            h.source = _source_to(h.source, dev)
        self._gids = [g.to(dev) for g, dev in zip(self._gids, self.mesh.devices.flat)]

    # -- stacked views (the JAX package's arrays) ----------------------------

    @property
    def layers_stacked(self) -> List[Layer]:
        """Per level ``(nodes [S, N], neighbors [S, N, M])`` on the mesh's
        first device (a copy; ``[]`` for a scan-only index)."""
        first = self.mesh.first
        return [
            Layer(_stack([h.layers[lvl].nodes for h in self._shards], first),
                  _stack([h.layers[lvl].neighbors for h in self._shards], first))
            for lvl in range(self._shards[0].layer_count)
        ]

    @property
    def source_stacked(self) -> Source:
        """The shard-major source on the mesh's first device (a copy)."""
        first = self.mesh.first
        sources = [h.source for h in self._shards]
        if isinstance(sources[0], DenseSource):
            return DenseSource(vectors=_stack([s.vectors for s in sources], first))
        return PqSource(codes=_stack([s.codes for s in sources], first),
                        codebook=sources[0].codebook.to(first))

    @property
    def global_ids(self) -> torch.Tensor:
        """``[S, N]`` int32 on the mesh's first device (a copy)."""
        return _stack(self._gids, self.mesh.first)

    def shard_source(self, s: int) -> Source:
        """Shard ``s``'s (padded) source, on its device."""
        return self._shards[s].source

    def shard_global_ids(self, s: int) -> torch.Tensor:
        return self._gids[s]

    @property
    def has_graphs(self) -> bool:
        return self._shards[0].layer_count > 0

    @property
    def n_shards(self) -> int:
        return int(self.mesh.devices.size)

    @property
    def vector_count(self) -> int:
        return int(sum(int((g != EMPTY_ID).sum()) for g in self._gids))

    # -- query ---------------------------------------------------------------

    def _to_global(self, s: int, ids: torch.Tensor, dists: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard ``s``'s local ids as global ids (padding rows -> EMPTY),
        sorted by ``(dist, id)`` and cut to ``k``."""
        gids = self._gids[s]
        safe = torch.clamp(ids, 0, gids.shape[0] - 1).long()
        g = torch.where(ids == EMPTY_ID, EMPTY_ID, gids[safe])
        dists = torch.where(g == EMPTY_ID, EMPTY_DIST, dists)
        g, dists = sort_queue(g, dists)
        return g[:, :k], dists[:, :k]

    def _check_graphs(self, what: str) -> None:
        if not self.has_graphs:
            raise ValueError(
                f"scan-only sharded index (build_graphs=False) has no shard graphs {what}"
            )

    def _shard_search(self, s: int, queries: torch.Tensor,
                      sp: SearchParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard ``s``'s graph search over its padded layers, on its device."""
        h = self._shards[s]
        return graph_search(h.layers, h.compute_source, self.metric,
                            queries.to(self.mesh.devices.flat[s]), sp)

    def search(
        self, queries: torch.Tensor, sp: Optional[SearchParams] = None, k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every shard's graph search, its local ids mapped to global ones,
        then the top-k merge across shards.  Results land on the mesh's
        first device."""
        self._check_graphs("; query it with search_exact()")
        sp = sp or self.build_parameters.optimization.search
        k = k or sp.number_of_candidates
        parts = [self._to_global(s, *self._shard_search(s, queries, sp), k)
                 for s in range(self.n_shards)]
        return _merge(parts, k, self.mesh.first, dedup=False)

    def search_exact(
        self,
        queries: torch.Tensor,
        k: int = 10,
        fast: bool = False,
        oversample: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat-scan the whole sharded corpus: every shard scans its slice
        (the exact pairwise scan, or with ``fast`` the fast scan that keeps
        ``oversample * k`` survivors and an in-shard full-precision rerank of
        them), then the top-k merge across shards.  The mesh-scale
        counterpart of :meth:`Hnsw.search_exact`."""
        return self._scan_shards(queries, k, k * oversample if fast else k, fast,
                                 lambda s: self.shard_source(s) if fast else None)

    def _scan_shards(self, queries: torch.Tensor, k: int, k_scan: int, fast: bool,
                     rerank: Callable[[int], Optional[Source]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every shard's :func:`_shard_flat_scan` of ``k_scan`` survivors,
        rescored in the shard against ``rerank(s)``'s rows where it gives a
        source (``EMPTY`` -> +inf), as global ids merged to the top ``k``."""
        parts = []
        for s, dev in enumerate(self.mesh.devices.flat):
            local = self.shard_source(s)
            q = queries.to(dev).contiguous()
            best_i, best_d = _shard_flat_scan(local, q, self.metric, min(k_scan, local.count), fast)
            full = rerank(s)
            if full is not None:
                best_i, best_d = sort_queue(best_i, source_distance(full, q, best_i, self.metric))
            parts.append(self._to_global(s, best_i, best_d, k))
        return _merge(parts, k, self.mesh.first, dedup=True)

    # -- shard round-trip (improve / persistence) -----------------------------

    def _shard_hnsw(self, s: int) -> Hnsw:
        """Shard ``s`` as a standalone Hnsw on its device: padding nodes
        stripped (a replicated-top level keeps one node), zero layers for a
        scan-only index."""
        h = self._shards[s]
        layers = []
        for l in h.layers:
            real = max(1, int((l.nodes != EMPTY_ID).sum()))
            layers.append(Layer(nodes=l.nodes[:real], neighbors=l.neighbors[:real]))
        return Hnsw(layers, h.source, self.metric, self.build_parameters)

    def _restack_from_hnsws(self, shard_hnsws: List[Hnsw],
                            keep_levels: Optional[set] = None) -> None:
        """Re-stack per-shard graphs: equalize the ladders by replicating a
        shorter shard's top level, then pad each level to the widest shard's
        node and neighbor counts.  Levels in ``keep_levels`` (unchanged in
        every shard) keep their padded tensors."""
        max_lc = max(h.layer_count for h in shard_hnsws)
        for h in shard_hnsws:
            while h.layer_count < max_lc:
                h.layers.insert(0, h.layers[0])
        old = [list(h.layers) for h in self._shards]
        new = [[] for _ in shard_hnsws]
        for lvl in range(max_lc):
            if keep_levels is not None and lvl in keep_levels and lvl < len(old[0]):
                for s in range(len(shard_hnsws)):
                    new[s].append(old[s][lvl])
                continue
            n_max = max(h.layers[lvl].node_count for h in shard_hnsws)
            m_max = max(h.layers[lvl].neighborhood_size for h in shard_hnsws)
            for s, h in enumerate(shard_hnsws):
                l = h.layers[lvl]
                n, m = l.neighbors.shape
                nodes = torch.full((n_max,), EMPTY_ID, dtype=ID_DTYPE, device=l.nodes.device)
                neigh = torch.full((n_max, m_max), EMPTY_ID, dtype=ID_DTYPE, device=l.nodes.device)
                nodes[:n] = l.nodes
                neigh[:n, :m] = l.neighbors
                new[s].append(Layer(nodes, neigh))
        for h, layers in zip(self._shards, new):
            h.layers = layers
        self.place()

    def improve_index(self, bp: Optional[BuildParams] = None, progress=None,
                      parallel: bool = True) -> float:
        """Per-shard ``improve_index`` (shards are independent graphs), in
        shard order (``parallel`` is taken for the JAX signature).  Only
        levels some shard changed are re-stacked: the port's relink returns
        the same ``neighbors`` tensor when it changes nothing, so a level is
        unchanged exactly where every shard's tensor kept its identity, as in
        the JAX package.  Returns the minimum shard recall."""
        self._check_graphs("to improve; rebuild with build_graphs=True")
        bp = bp or self.build_parameters
        devices = list(self.mesh.devices.flat)
        hnsws = [self._shard_hnsw(s) for s in range(self.n_shards)]
        before = [(h.layer_count, [id(l.neighbors) for l in h.layers]) for h in hnsws]

        def improve_one(s: int) -> float:
            with _on(devices[s]):
                return hnsws[s].improve_index(bp, progress=progress)

        recalls = _for_each_shard(improve_one, devices)
        if any(h.layer_count != b[0] for h, b in zip(hnsws, before)):
            # promotions skew ladders / extend lower levels: full restack
            self._restack_from_hnsws(hnsws)
        else:
            changed = {
                lvl
                for h, b in zip(hnsws, before)
                for lvl in range(h.layer_count)
                if id(h.layers[lvl].neighbors) != b[1][lvl]
            }
            if changed:
                keep = set(range(self._shards[0].layer_count)) - changed
                self._restack_from_hnsws(hnsws, keep_levels=keep)
        return float(min(recalls))

    def _stacked_rows(self, s_idx: np.ndarray, i_idx: np.ndarray) -> torch.Tensor:
        """Full-precision rows at (shard, local) positions, reconstructed for
        PQ shards, on the mesh's first device in the order given."""
        first = self.mesh.first
        out = torch.empty((len(s_idx), self._shards[0].source.dim), dtype=torch.float32,
                          device=first)
        for s, dev in enumerate(self.mesh.devices.flat):
            where = np.nonzero(s_idx == s)[0]
            if len(where):
                rows = source_get(self._shards[s].source,
                                  torch.as_tensor(i_idx[where], dtype=ID_DTYPE, device=dev))
                out[torch.as_tensor(where, device=first)] = rows.to(first)
        return out

    def stochastic_recall(self, op: Optional[OptimizationParams] = None, seed: int = 42) -> float:
        """Sampled self-findability across the whole sharded corpus
        (reference: stochastic_recall, src/lib.rs:1501-1505, applied to the
        distributed index); the sample is the JAX package's numpy draw."""
        op = op or self.build_parameters.optimization
        gids = np.stack([to_numpy(g) for g in self._gids])
        s_idx, i_idx = np.nonzero(gids != EMPTY_ID)
        total = len(s_idx)
        selection = max(1, int(total * op.recall_proportion))
        pick = np.random.default_rng(seed).permutation(total)[:selection]
        queries = self._stacked_rows(s_idx[pick], i_idx[pick])
        want = gids[s_idx[pick], i_idx[pick]]
        ids, _ = self.search(queries, op.search, k=op.search.number_of_candidates)
        found = np.any(to_numpy(ids) == want[:, None], axis=-1)
        return float(found.mean())


class ShardedQuantizedHnsw:
    """PQ-compressed sharded index: the JAX package's 100M-config layout.

    One quantizer (a centroid graph over a shared codebook, or per-subspace
    codebooks) serves every shard; each shard keeps its PQ codes (and, with
    graphs, its own code graph) on its device.  Search quantizes the query,
    fans out to every shard's code-graph search, reranks against the
    full-precision rows and merges top-k across shards (reference:
    QuantizedHnsw::search's rerank, src/pq.rs:346-364).

    In core (``full_stacked``: per-shard ``[N, D]`` f32 rows on the shards'
    devices) each shard reranks its own candidates before the merge.  Out of
    core (``full_host``: a :class:`~parallel_hnsw_tpu_torch.graph.MemmapSource`)
    the f32 rows stay on disk: each shard quantizes its own rows in streamed
    chunks on its device, only codes persist there, and a search merges the
    code-exact top ``oversample * k`` first and then reranks once, gathering
    just those rows from the memmap on the host.
    """

    def __init__(
        self,
        quantizer,
        sharded: ShardedHnsw,
        full_stacked=None,  # [S, N, D] (or one [N, D] per shard): in core
        full_host=None,  # MemmapSource: out of core
    ):
        if (full_stacked is None) == (full_host is None):
            raise ValueError("give exactly one of full_stacked (in core) and full_host (out of core)")
        self.quantizer = quantizer
        self.sharded = sharded
        self.full_host = full_host
        self._full: Optional[List[torch.Tensor]] = None
        if full_stacked is not None:
            self._full = [_tensor(full_stacked[s], dev).float()
                          for s, dev in enumerate(sharded.mesh.devices.flat)]

    @property
    def full_stacked(self) -> Optional[torch.Tensor]:
        """``[S, N, D]`` f32 on the mesh's first device (a copy), in core;
        ``None`` out of core."""
        return None if self._full is None else _stack(self._full, self.sharded.mesh.first)

    def shard_full(self, s: int) -> torch.Tensor:
        """Shard ``s``'s in-core full-precision rows ``[N, D]``, on its device."""
        return self._full[s]

    @classmethod
    def new(
        cls,
        number_of_centroids: int,
        full_source: Source,
        dsub: int,
        metric: Metric,
        mesh: Mesh,
        pqp: Optional[PqBuildParams] = None,
        seed: int = 0,
        use_kmeans: bool = False,
        exact_quantize: bool = False,
        fast_quantize: bool = False,
        chunk_size: int = 100_000,
        improve: bool = True,
        verbose: bool = False,
        build_graphs: bool = True,
        per_subspace: bool = False,
        projection=None,
        shuffle=None,
    ) -> "ShardedQuantizedHnsw":
        """The quantizer on the mesh's first device (shared codebook: random or
        k-means centroids and their graph; ``per_subspace``: one codebook per
        subspace), then the codes and the sharded index over them.

        A dense ``full_source`` is quantized in ``chunk_size`` chunks on its
        device, partitioned like :meth:`ShardedHnsw.generate`, and its rows
        stacked shard-major as ``full_stacked``.  A MemmapSource is partitioned
        FIRST; each shard streams its own rows from disk in ``chunk_size``
        chunks (``MemmapSource.chunks(ids=...)``) and quantizes them on its
        device against its own copy of the codebook, by the per-subspace,
        binned (``fast_quantize``), exact (``exact_quantize``) or graph route;
        codes come back as host arrays and only codes go to the device.  The
        ``ooc_ingest_shard`` span (``rows``, ``bytes``) times each shard.

        ``projection`` / ``shuffle`` replace the default draws of random
        centroids, as in :meth:`QuantizedHnsw.new`."""
        pqp = pqp or PqBuildParams()
        metric = Metric(metric)
        dim = full_source.dim
        if dim % dsub:
            raise ValueError(f"dim {dim} is not a multiple of dsub {dsub}")
        nsub = dim // dsub
        out_of_core = is_host_source(full_source)
        devices = list(mesh.devices.flat)
        qdev = mesh.first if out_of_core else full_source.device

        if per_subspace:
            kw = {"sample": 4_000_000} if out_of_core else {}
            codebook = per_subspace_centroids(
                full_source.vectors, number_of_centroids, dsub, seed=seed,
                use_kmeans=use_kmeans, device=qdev, projections=projection, shuffles=shuffle,
                **kw,
            )
            quantizer = SubspaceQuantizer(codebook, metric, pqp)
        else:
            if use_kmeans:
                kw = {"sample": 4_000_000} if out_of_core else {}
                codebook = kmeans_centroids(full_source.vectors, number_of_centroids, dsub,
                                            seed=seed, device=qdev, **kw)
            else:
                codebook = random_centroids(full_source.vectors, number_of_centroids, dsub,
                                            seed=seed, projection=projection, shuffle=shuffle,
                                            device=qdev)
            centroid_hnsw = Hnsw.generate(DenseSource(vectors=codebook), None, pqp.centroids,
                                          metric, seed=seed, verbose=verbose)
            centroid_hnsw.improve_index(pqp.centroids)
            quantizer = HnswQuantizer(centroid_hnsw, nsub, pqp)
        code_dtype = code_dtype_for(codebook.shape[-2])

        def narrow(codes: torch.Tensor) -> torch.Tensor:
            return narrow_codes(codes) if code_dtype == torch.uint16 else codes.to(code_dtype)

        rows, shard_gids = _partition(full_source.count, len(devices))
        if out_of_core:
            shard_sources: List[Optional[Source]] = [None] * len(devices)

            def quantize_shard(s: int) -> None:
                dev = devices[s]
                real = int((shard_gids[s] != EMPTY_ID).sum())
                cb = codebook.to(dev)  # the shard device's own copy
                local_q = SubspaceQuantizer(cb, metric, pqp) if per_subspace else None
                host_codes = []
                with TRACER.span("ooc_ingest_shard", sync=torch.empty(0, device=dev), rows=real,
                                 bytes=real * dim * full_source.vectors.itemsize), _on(dev):
                    for chunk in full_source.chunks(chunk_size, ids=rows[s]):
                        x = host_rows(chunk, dev)
                        if per_subspace:
                            c = local_q.quantize(x, fast=fast_quantize)
                        elif fast_quantize:
                            c = quantize_binned(x.reshape(-1, dsub), cb, metric)
                        elif exact_quantize:
                            c = blocked_topk_pairwise(x.reshape(-1, dsub), cb, metric, 1,
                                                      row_block=8192)[0][:, 0]
                        else:
                            # the graph route runs on the centroid graph's
                            # own device (it is not replicated)
                            c = quantizer.quantize(x.to(qdev))
                        host_codes.append(to_numpy(narrow(c.reshape(len(chunk), nsub))))
                shard_sources[s] = PqSource(codes=from_numpy(np.concatenate(host_codes), dev),
                                            codebook=cb)

            _for_each_shard(quantize_shard, devices)
            sharded = ShardedHnsw.from_shard_sources(
                shard_sources, shard_gids, mesh, pqp.hnsw, metric, seed=seed, improve=improve,
                verbose=verbose, build_graphs=build_graphs,
            )
            return cls(quantizer, sharded, full_host=full_source)

        vectors = full_source.vectors
        codes = torch.cat([
            quantizer.quantize(vectors[start : start + chunk_size], exact=exact_quantize,
                               fast=fast_quantize)
            for start in range(0, full_source.count, chunk_size)
        ])
        pq_source = PqSource(codes=narrow(codes), codebook=codebook)
        sharded = ShardedHnsw.generate(
            pq_source, mesh, pqp.hnsw, metric, seed=seed, improve=improve, verbose=verbose,
            build_graphs=build_graphs,
        )
        # the full-precision rows, shard-major with the same partition
        full = [_take_rows(vectors, rows[s], dev) for s, dev in enumerate(devices)]
        return cls(quantizer, sharded, full)

    def search(
        self,
        queries: torch.Tensor,
        sp: Optional[SearchParams] = None,
        k: int = 10,
        oversample: int = 4,
        exact_quantize: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize the queries, search every shard's code graph, rerank
        exactly, merge.  In core, each shard reranks its top
        ``oversample * k`` against its resident rows before the merge; out
        of core, the code-exact top ``oversample * k`` merge first and one
        host rerank gathers their rows from the memmap."""
        sh = self.sharded
        sp = sp or sh.build_parameters.optimization.search
        qrecon = self.quantizer.reconstruct(self.quantizer.quantize(queries, exact=exact_quantize))
        if self._full is None:
            ids, _ = sh.search(qrecon, sp, k=oversample * k)
            ids, dists = self._host_rerank(queries, ids)
            return ids[:, :k], dists[:, :k]
        sh._check_graphs("; query it with search_exact()")
        parts = []
        for s, dev in enumerate(sh.mesh.devices.flat):
            ids, _ = sh._shard_search(s, qrecon, sp)
            cand = ids[:, : min(k * oversample, ids.shape[1])]
            # in-shard exact rerank (EMPTY -> +inf)
            d = source_distance(DenseSource(vectors=self._full[s]), queries.to(dev), cand,
                                sh.metric)
            r_ids, r_d = sort_queue(cand, d)
            parts.append(sh._to_global(s, r_ids[:, :k], r_d[:, :k], k))
        return _merge(parts, k, sh.mesh.first, dedup=False)

    def search_exact(
        self,
        queries: torch.Tensor,
        k: int = 10,
        oversample: int = 4,
        fast: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat scan over every shard's codes + exact full-precision rerank.

        In core, each shard reranks its ``oversample * k`` code-scan survivors
        against its resident f32 rows before the merge; out of core, the
        code-exact candidates merge first, then one host rerank gathers rows
        from the memmap.  Both return true f32 distances (reference rerank
        contract: src/pq.rs:346-364)."""
        sh = self.sharded
        if self._full is None:
            ids, _ = sh.search_exact(queries, k=oversample * k, fast=fast)
            ids, dists = self._host_rerank(queries, ids)
            return ids[:, :k], dists[:, :k]
        return sh._scan_shards(queries, k, k * oversample, fast,
                               lambda s: DenseSource(vectors=self._full[s]))

    def _host_rerank(self, queries: torch.Tensor, ids: torch.Tensor):
        return exact_rerank(self.full_host, self.sharded.metric, queries.to(ids.device), ids)

    def stochastic_recall(self, op: Optional[OptimizationParams] = None, seed: int = 42) -> float:
        return self.sharded.stochastic_recall(op, seed)

    def improve_index(self, bp: Optional[BuildParams] = None) -> float:
        return self.sharded.improve_index(bp)
