"""Product quantization: two-level index with exact rerank (counterpart of
``parallel_hnsw_tpu.pq``).

Reference (src/pq.rs): an ``HnswQuantizer`` is an HNSW over a *shared*
codebook of sub-vector centroids (src/pq.rs:29-82); ``quantize`` runs one
centroid-graph search per sub-vector (src/pq.rs:61-71); the ``QuantizedHnsw``
builds a second HNSW over the codes where every comparison reconstructs both
vectors from centroids (src/pq.rs:585-600), and ``search`` quantizes the
query, searches the code graph, then exact-reranks with the full-precision
vectors (src/pq.rs:346-364).  Centroids come from random sub-vector sampling
(src/pq.rs:261-285) with a latent k-means path (src/pq.rs:215-259).

On the card no kernel is new here: quantization runs through the binned-scan
kernel (``fast``), the pairwise-distance kernel (``exact``) or a centroid-graph
search; reconstruction through the row-gather kernel; the code graph's hop,
on the densified copy, through the gather-and-distance kernel.  ADC tables
(the reference's never-implemented ``PartialDistance``, src/pq.rs:24-27) and
k-means are torch ops in fp32, as they are XLA ops in the JAX package.

Divergences from the JAX package, by design: its ``jax.random`` draws (the
dedup hash's gaussian projection and the centroid shuffle) cannot be
reproduced by torch, so they are injectable and default to seeded numpy
streams (:func:`dedup_projection`, :func:`shuffle_keys`); ``approx_min_k``
becomes an exact ``torch.topk``.  The numpy draws match bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise
from parallel_hnsw_tpu_torch.constants import ID_DTYPE
# the code scan reaches its survivor cut and its decode (``reconstruct``)
# through this module's globals, at call time: benchmark/pq_faults.py plants
# its faults there
from parallel_hnsw_tpu_torch.flat import block_scan, blocked_scan, exact_rerank
from parallel_hnsw_tpu_torch.flat import cut_survivors as _cut_survivors
from parallel_hnsw_tpu_torch.graph import (
    DenseSource,
    MemmapSource,
    PqSource,
    host_rows,
    is_host_source,
    narrow_codes,
    reconstruct,
    source_effective_width,
    widen_codes,
)
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.cuda_gather import gather_distance, row_gather
from parallel_hnsw_tpu_torch.ops.cuda_scan import binned_scan, scan_operand
from parallel_hnsw_tpu_torch.ops.distance import Metric, check_fp32_matmul, pairwise_distance
from parallel_hnsw_tpu_torch.params import (
    BuildParams,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
)
from parallel_hnsw_tpu_torch.progress import ProgressMonitor, ensure_monitor
from parallel_hnsw_tpu_torch.utils import device as _device
from parallel_hnsw_tpu_torch.utils.trace import TRACER

Vectors = Union[torch.Tensor, np.ndarray]


def _as_tensor(vectors: Vectors, device=None) -> torch.Tensor:
    """A tensor as it is; a numpy array as f32 on ``device`` (``None``: the
    card)."""
    if isinstance(vectors, torch.Tensor):
        return vectors
    return torch.as_tensor(np.asarray(vectors, np.float32), device=_device.resolve_device(device))


def code_dtype_for(n_centroids: int) -> torch.dtype:
    """``uint16`` codes when the codebook fits them, else int32 (reference
    parity: u16 codes, src/pq.rs:20)."""
    return torch.uint16 if n_centroids <= 65536 else torch.int32


def _draws(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream]))


# ---------------------------------------------------------------------------
# Centroid selection


def dedup_projection(seed: int, dim: int, device=None) -> torch.Tensor:
    """The gaussian ``[dim]`` projection of the dedup hash (the JAX package's
    ``jax.random.normal(PRNGKey(seed), (dim,))``), from a numpy stream seeded
    by ``seed``."""
    g = _draws(seed, 0).standard_normal(dim).astype(np.float32)
    return torch.from_numpy(g).to(_device.resolve_device(device))


def shuffle_keys(seed: int, n: int, device=None) -> torch.Tensor:
    """The uniform ``[n]`` keys of the centroid shuffle (the JAX package's
    ``jax.random.uniform(fold_in(PRNGKey(seed), 1), (n,))``), from a numpy
    stream seeded by ``seed``."""
    u = _draws(seed, 1).random(n, dtype=np.float32)
    return torch.from_numpy(u).to(_device.resolve_device(device))


def _hash_sort_dedup(subs: torch.Tensor, projection: torch.Tensor):
    """Sort rows by a gaussian-projection hash; mark adjacent duplicates.

    Identical rows hash identically so they sort adjacent; a hash tie between
    *different* rows (probability ~0 for a gaussian projection over f32)
    would at worst retain a duplicate, which the reference's sampling
    tolerates anyway.  Returns ``(sorted_rows, dup_mask)`` with ``dup_mask[i]``
    true iff row i equals row i-1.  The hash sums one column at a time, so
    identical rows get identical hashes whatever a matmul's blocking does."""
    projection = projection.to(subs.device)
    h = subs[:, 0] * projection[0]
    for j in range(1, subs.shape[1]):
        h = h + subs[:, j] * projection[j]
    order = torch.argsort(h, stable=True)
    s, hs = subs[order], h[order]
    dup = torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
    dup[1:] = (hs[1:] == hs[:-1]) & (s[1:] == s[:-1]).all(dim=-1)
    return s, dup


def unique_rows_device(
    subs: Vectors, seed: int = 0, projection: Optional[torch.Tensor] = None
) -> np.ndarray:
    """Row dedup on the device (see ``_hash_sort_dedup``); rows return sorted
    by their hash, deterministic for a fixed projection (default:
    :func:`dedup_projection` of ``seed``)."""
    subs = _as_tensor(subs)
    if projection is None:
        projection = dedup_projection(seed, subs.shape[1], subs.device)
    s, dup = _hash_sort_dedup(subs, projection)
    return s[~dup].cpu().numpy()


def random_centroids(
    vectors: Vectors,
    n_centroids: int,
    dsub: int,
    seed: int = 0,
    projection: Optional[torch.Tensor] = None,
    shuffle: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Sample vectors, split into sub-vectors, dedup, shuffle, truncate
    (reference: random_centroids, src/pq.rs:261-285).  Returns ``[K, dsub]``
    f32 on the vectors' device (a numpy corpus is sampled on the host and
    only the sample goes to ``device``).

    ``projection`` (``[dsub]``) and ``shuffle`` (one key per sampled
    sub-vector) replace the default draws of :func:`dedup_projection` and
    :func:`shuffle_keys`; the sample itself is numpy's, as in the JAX
    package.  The sampled rows are read in ascending order from a tensor as
    from a memmap (the JAX package sorts them for a host array only): rows
    that tie on the dedup hash keep their order through its stable sort, so
    the same rows give the same centroids whatever holds them."""
    count, dim = vectors.shape
    if dim % dsub:
        raise ValueError(f"dim {dim} is not a multiple of dsub {dsub}")
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.permutation(count)[: min(n_centroids, count)])
    if isinstance(vectors, np.ndarray):
        subs = _as_tensor(vectors[sel], device).reshape(-1, dsub)
    else:
        idx = torch.as_tensor(sel, dtype=ID_DTYPE, device=vectors.device)
        subs = row_gather(vectors.contiguous(), idx).reshape(-1, dsub)
    if projection is None:
        projection = dedup_projection(seed, dsub, subs.device)
    s, dup = _hash_sort_dedup(subs, projection)
    # random shuffle with duplicates sunk to the tail, then truncate: the
    # first min(K, n_unique) rows are unique and uniformly ordered
    if shuffle is None:
        shuffle = shuffle_keys(seed, s.shape[0], s.device)
    perm = torch.argsort(dup.float() + shuffle.to(s.device), stable=True)
    k = min(n_centroids, int((~dup).sum()))
    return s[perm[:k]].contiguous()


def _kmeans_plain(data: torch.Tensor, init: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Lloyd's loop on the full ``[N, K]`` distance matrix (plain
    ``pairwise_distance``, as the JAX package's XLA loop)."""
    centroids = init.float()
    for _ in range(iters):
        d = pairwise_distance(data, centroids, Metric.SQUARED_EUCLIDEAN)
        assign = torch.argmin(d, dim=-1)
        sums = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device)
        sums.index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=k).float()[:, None]
        centroids = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centroids)
    return centroids


def _kmeans_big(
    subs: torch.Tensor, init: torch.Tensor, k: int, iters: int, block: int = 1 << 21
) -> torch.Tensor:
    """Lloyd's k-means at large K without the ``[N, K]`` distance matrix:
    assignment via the binned-scan argmin (:func:`quantize_binned`, an exact
    rerank of per-class survivors), update via ``index_add_``.  Makes
    K=65,535 trainable (the plain loop's ``[2M, 65535]`` f32 matrix is
    512 GB)."""
    centroids = init.float()
    for _ in range(iters):
        sums = torch.zeros((k, subs.shape[1]), dtype=torch.float32, device=subs.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=subs.device)
        for start in range(0, subs.shape[0], block):
            chunk = subs[start : start + block]
            assign = quantize_binned(chunk, centroids, Metric.SQUARED_EUCLIDEAN, block=block).long()
            sums.index_add_(0, assign, chunk)
            counts.index_add_(0, assign, torch.ones_like(chunk[:, 0]))
        centroids = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centroids
        )
    return centroids


def kmeans_centroids(
    vectors: Vectors,
    n_centroids: int,
    dsub: int,
    iters: int = 5,
    seed: int = 42,
    sample: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Lloyd's k-means over sub-vectors (the reference's latent linfa path:
    1 run, <=5 iterations, seed 42; src/pq.rs:215-259).  Returns ``[K, dsub]``
    f32.  The sample and the initial centroids are numpy draws of ``seed``
    (those of the JAX package).

    Above a ``[N, K]`` assignment-matrix budget the plain loop is swapped for
    the blocked binned-argmin + ``index_add_`` formulation
    (:func:`_kmeans_big`).  A numpy (or memmap) corpus is sampled on the
    host: only the sample goes to ``device``."""
    subs = vectors.reshape(-1, dsub)
    if sample is not None and sample < len(subs):
        rng = np.random.default_rng(seed)
        if len(subs) > 50_000_000:
            # a full permutation array would itself be tens of GB: sample
            # with replacement instead (collision odds are negligible)
            sel = np.sort(rng.integers(0, len(subs), sample))
        else:
            sel = rng.permutation(len(subs))[:sample]
        if isinstance(subs, torch.Tensor):
            subs = subs[torch.as_tensor(sel, device=subs.device)]
        else:
            subs = subs[sel]
    subs = _as_tensor(subs, device)
    k = min(n_centroids, len(subs))
    rng = np.random.default_rng(seed)
    if len(subs) > 50_000_000:
        isel = np.sort(rng.integers(0, len(subs), k * 4))[::4][:k]
    else:
        isel = rng.permutation(len(subs))[:k]
    subs = subs.float().contiguous()
    init = subs[torch.as_tensor(isel, device=subs.device)]
    if len(subs) * k > (1 << 31):  # [N, K] f32 would exceed ~8 GB
        return _kmeans_big(subs, init, k, iters)
    return _kmeans_plain(subs, init, k, iters)


# ---------------------------------------------------------------------------
# Quantizer


def _quantize_binned_block(
    subs: torch.Tensor, centroids: torch.Tensor, cent_op: torch.Tensor, metric: Metric, kk: int
) -> torch.Tensor:
    bd, bc = binned_scan(scan_operand(subs), cent_op, metric, tile_c=4096, exact=False)
    _, pos = torch.topk(bd, kk, dim=-1, largest=False)
    cand = torch.gather(bc, -1, pos)  # [B, kk] centroid ids
    d = gather_distance(subs, centroids, cand, metric)  # exact rerank
    best = torch.argmin(d, dim=-1, keepdim=True)
    return torch.gather(cand, -1, best)[:, 0]


def quantize_binned(
    subs: torch.Tensor,
    centroids: torch.Tensor,
    metric: Metric,
    block: int = 1 << 18,
    kk: int = 8,
) -> torch.Tensor:
    """Near-exact sub-vector argmin ``[N] int32``: the fast binned scan
    keeps each tile's per-class minima, the ``kk`` best bins survive, and an
    exact fp32 rerank of their centroids (one gather-and-distance launch)
    picks the argmin, in blocks of ``block`` sub-vectors.  Misses only where
    the true argmin shares tile and class with a closer bf16 score."""
    metric = Metric(metric)
    centroids = centroids.float().contiguous()
    kk = min(kk, centroids.shape[0])
    cent_op = scan_operand(centroids)  # the bf16 copy (rows padded to 8 on the card), once
    outs = [
        _quantize_binned_block(subs[s : s + block].contiguous(), centroids, cent_op, metric, kk)
        for s in range(0, subs.shape[0], block)
    ]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


class HnswQuantizer:
    """HNSW over a shared sub-vector codebook (reference: src/pq.rs:29-82)."""

    def __init__(self, centroid_hnsw: Hnsw, nsub: int, pq_params: PqBuildParams):
        self.hnsw = centroid_hnsw
        self.nsub = nsub
        self.pq_params = pq_params

    @property
    def centroids(self) -> torch.Tensor:
        return self.hnsw.source.vectors  # [K, dsub]

    @property
    def dsub(self) -> int:
        return int(self.centroids.shape[1])

    def quantize(self, vecs: torch.Tensor, exact: bool = False, fast: bool = False) -> torch.Tensor:
        """``[B, SIZE] -> [B, nsub] int32`` codes.  Graph search per
        sub-vector like the reference (src/pq.rs:61-71), exact blocked argmin
        through the pairwise kernel (``exact``), or the binned-scan argmin
        (``fast``), the bulk route for large corpora."""
        b = vecs.shape[0]
        subs = vecs.reshape(b * self.nsub, self.dsub)
        if fast:
            codes = quantize_binned(subs, self.centroids, self.hnsw.metric)
        elif exact:
            ids, _ = blocked_topk_pairwise(subs, self.centroids, self.hnsw.metric, 1, row_block=8192)
            codes = ids[:, 0]
        else:
            ids, _ = self.hnsw.search(subs, self.pq_params.quantized_search, query_block=65536)
            codes = ids[:, 0]
        return codes.reshape(b, self.nsub).to(ID_DTYPE)

    def reconstruct(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, nsub] -> [B, SIZE]`` (reference: src/pq.rs:73-81)."""
        return reconstruct(self.centroids, codes)


# ---------------------------------------------------------------------------
# Per-subspace quantizer: classic PQ (nsub independent codebooks)


def per_subspace_centroids(
    vectors: Vectors,
    n_centroids: int,
    dsub: int,
    seed: int = 0,
    use_kmeans: bool = True,
    iters: int = 5,
    sample: Optional[int] = None,
    device=None,
    projections: Optional[Sequence[torch.Tensor]] = None,
    shuffles: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Train one ``[K, dsub]`` codebook per subspace -> ``[nsub, K, dsub]``
    on the vectors' device (a numpy or memmap corpus: on ``device``, each
    subspace's column read on the host).  Subspace ``j`` trains with seed
    ``seed + j`` (random centroids: with ``projections[j]`` /
    ``shuffles[j]`` in place of the default draws when given); one with
    fewer than K unique rows is tiled up to K (harmless duplicates)."""
    if isinstance(vectors, torch.Tensor):
        device = vectors.device
    else:
        device = _device.resolve_device(device)
    dim = vectors.shape[1]
    if dim % dsub:
        raise ValueError(f"dim {dim} is not a multiple of dsub {dsub}")
    nsub = dim // dsub
    books = torch.empty((nsub, n_centroids, dsub), dtype=torch.float32, device=device)
    for j in range(nsub):
        col = vectors[:, j * dsub : (j + 1) * dsub]
        if use_kmeans:
            cb = kmeans_centroids(col, n_centroids, dsub, iters=iters, seed=seed + j,
                                  sample=sample, device=device)
        else:
            cb = random_centroids(
                col, n_centroids, dsub, seed=seed + j, device=device,
                projection=None if projections is None else projections[j],
                shuffle=None if shuffles is None else shuffles[j],
            )
        if len(cb) < n_centroids:
            reps = -(-n_centroids // len(cb))
            cb = cb.repeat(reps, 1)[:n_centroids]
        books[j] = cb
    return books


class SubspaceQuantizer:
    """Per-subspace PQ quantizer: ``codebooks [nsub, K, dsub]``.

    Quantization is an exact (or binned) argmin per subspace; no centroid
    graph is needed because each subspace's K centroids scan in one blocked
    pass."""

    def __init__(self, codebooks: torch.Tensor, metric: Metric, pq_params: PqBuildParams):
        self.codebooks = codebooks.float().contiguous()  # [nsub, K, dsub]
        self.metric = Metric(metric)
        self.pq_params = pq_params

    @property
    def nsub(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def dsub(self) -> int:
        return int(self.codebooks.shape[2])

    @property
    def n_centroids(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def centroids(self) -> torch.Tensor:
        return self.codebooks

    def quantize(self, vecs: torch.Tensor, exact: bool = False, fast: bool = False) -> torch.Tensor:
        """``[B, SIZE] -> [B, nsub] int32`` codes, each subspace against its
        own codebook.  ``fast`` with K >= 4096 takes the binned-scan argmin;
        otherwise an exact blocked argmin (``exact`` is accepted for
        signature parity: there is no graph tier here).

        Assignment always minimizes SQUARED_EUCLIDEAN sub-vector error, the
        reconstruction-error objective, whatever the index metric."""
        del exact
        am = Metric.SQUARED_EUCLIDEAN
        cols = []
        for j in range(self.nsub):
            sub = vecs[:, j * self.dsub : (j + 1) * self.dsub].contiguous()
            cb = self.codebooks[j]
            if fast and self.n_centroids >= 4096:
                c = quantize_binned(sub, cb, am)
            else:
                c = blocked_topk_pairwise(sub, cb, am, 1, row_block=8192)[0][:, 0]
            cols.append(c)
        return torch.stack(cols, dim=1).to(ID_DTYPE)

    def reconstruct(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, nsub] -> [B, SIZE]`` via the per-subspace codebook gather."""
        return reconstruct(self.codebooks, codes)


# ---------------------------------------------------------------------------
# ADC lookup tables: the reference's PartialDistance made real

_DOT_FAMILY = (Metric.COSINE, Metric.NORMALIZED_COSINE, Metric.DOT)


def adc_lut(queries: torch.Tensor, codebook: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Per-query partial-distance tables ``[Q, nsub, K]``.

    For dot-family metrics the partial is the negated sub-dot; for euclidean
    the squared sub-distance.  :func:`adc_finish` maps summed partials back
    to the metric's distance.  Products are fp32 (TF32 refused)."""
    metric = Metric(metric)
    check_fp32_matmul(queries)
    q, size = queries.shape
    if codebook.dim() == 2:
        k, dsub = codebook.shape
        nsub = size // dsub
        subs = queries.reshape(q * nsub, dsub)
        if metric in _DOT_FAMILY:
            lut = -(subs @ codebook.T)
        else:
            lut = pairwise_distance(subs, codebook, Metric.SQUARED_EUCLIDEAN)
        return lut.reshape(q, nsub, k)
    nsub, k, dsub = codebook.shape
    subs = queries.reshape(q, nsub, dsub)
    if metric in _DOT_FAMILY:
        return -torch.einsum("qnd,nkd->qnk", subs, codebook)
    diff = subs[:, :, None, :] - codebook[None]
    return torch.sum(diff * diff, dim=-1)


def adc_finish(partial_sums: torch.Tensor, metric: Metric) -> torch.Tensor:
    metric = Metric(metric)
    if metric is Metric.COSINE:
        return 1.0 + partial_sums
    if metric is Metric.NORMALIZED_COSINE:
        return (1.0 + partial_sums) / 2.0
    if metric in (Metric.DOT, Metric.SQUARED_EUCLIDEAN):
        return partial_sums
    return torch.sqrt(torch.clamp(partial_sums, min=0.0))


def adc_scan(lut: torch.Tensor, codes: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Score all stored codes against per-query LUTs: ``[Q, nsub, K] x
    [N, nsub] -> [Q, N]``, the partials of the subspaces summed in order
    (one ``[Q, N]`` gather per subspace, so no ``[Q, N, nsub]`` block is
    held)."""
    q, nsub, k = lut.shape
    codes = widen_codes(codes).long()
    total = lut[:, 0, :].index_select(1, codes[:, 0])
    for j in range(1, nsub):
        total = total + lut[:, j, :].index_select(1, codes[:, j])
    return adc_finish(total, metric)


# ---------------------------------------------------------------------------
# QuantizedHnsw

Quantizer = Union[HnswQuantizer, SubspaceQuantizer]


class QuantizedHnsw:
    """Two-level PQ index (reference: QuantizedHnsw, src/pq.rs:120-411)."""

    def __init__(self, quantizer: Quantizer, hnsw: Hnsw, full_source: Union[DenseSource, MemmapSource]):
        self.quantizer = quantizer
        self.hnsw = hnsw  # graph over PqSource codes
        self.full_source = full_source

    # constructor (reference: QuantizedHnsw::new, src/pq.rs:287-344)
    @classmethod
    def new(
        cls,
        number_of_centroids: int,
        full_source: Union[DenseSource, MemmapSource],
        dsub: int,
        metric: Metric,
        pqp: Optional[PqBuildParams] = None,
        seed: int = 0,
        use_kmeans: bool = False,
        exact_quantize: bool = False,
        fast_quantize: bool = False,
        chunk_size: int = 100_000,
        code_dtype: Optional[torch.dtype] = None,
        per_subspace: bool = False,
        kmeans_sample: Optional[int] = None,
        kmeans_iters: int = 5,
        progress: Optional[ProgressMonitor] = None,
        verbose: bool = False,
        projection=None,
        shuffle=None,
        device=None,
        build_graph: bool = True,
    ) -> "QuantizedHnsw":
        """Centroids (random or k-means; shared or per subspace), the centroid
        graph and its ``improve_index`` (shared codebook only), the corpus
        quantized in ``chunk_size`` chunks into a :class:`PqSource` (``uint16``
        codes when K <= 65536), then the code graph over it.

        ``build_graph=False`` gives a **scan-only** index: everything above
        but the code graph, whose build at ten million rows takes longer than
        the codes themselves.  The index holds an :class:`Hnsw` with no
        layers over the codes; :meth:`search_exact` is its query engine, and
        the methods that walk or repair the graph raise (a parameter of the
        port alone: the JAX package always builds the graph).
        ``kmeans_iters`` is the Lloyd iterations of ``use_kmeans`` training
        (the port's too: the JAX package always runs 5).

        A DenseSource's index lands on its device.  A :class:`MemmapSource`
        (out of core) stays on the host: centroids are sampled from host rows,
        each chunk is copied to ``device`` (default: the card) alone, and
        ``full_source`` keeps the memmap, so the exact rerank of
        :meth:`search` / :meth:`search_exact` gathers its rows on the host;
        the f32 corpus never exists on the device as a whole.

        ``projection`` / ``shuffle`` replace the default draws of random
        centroids (:func:`random_centroids`; per subspace, one of each per
        subspace), so a caller can hand in the JAX package's own."""
        pqp = pqp or PqBuildParams()
        metric = Metric(metric)
        monitor = ensure_monitor(progress)
        monitor.update({"type": "pq"})
        dim = full_source.dim
        if dim % dsub:
            raise ValueError(f"dim {dim} is not a multiple of dsub {dsub}")
        nsub = dim // dsub
        host = is_host_source(full_source)
        device = _device.resolve_device(device) if host else full_source.device
        vectors = full_source.vectors
        sync = torch.empty(0, device=device)  # what the spans wait on: the device's queue

        if per_subspace:
            with TRACER.span("pq_subspace_centroids", sync=sync, n=number_of_centroids):
                centroids = per_subspace_centroids(
                    vectors, number_of_centroids, dsub, seed=seed, use_kmeans=use_kmeans,
                    iters=kmeans_iters, sample=kmeans_sample, device=device,
                    projections=projection, shuffles=shuffle,
                )
            monitor.alive()
            quantizer: Quantizer = SubspaceQuantizer(centroids, metric, pqp)
        else:
            with TRACER.span("pq_centroids", sync=sync, n=number_of_centroids):
                if use_kmeans:
                    centroids = kmeans_centroids(
                        vectors, number_of_centroids, dsub, iters=kmeans_iters, seed=seed,
                        sample=kmeans_sample, device=device,
                    )
                else:
                    centroids = random_centroids(
                        vectors, number_of_centroids, dsub, seed=seed, projection=projection,
                        shuffle=shuffle, device=device,
                    )
            monitor.alive()
            with TRACER.span("pq_centroid_graph", sync=sync):
                centroid_hnsw = Hnsw.generate(
                    DenseSource(vectors=centroids), None, pqp.centroids, metric, seed=seed,
                    progress=monitor, verbose=verbose,
                )
                centroid_hnsw.improve_index(pqp.centroids, progress=monitor)
            quantizer = HnswQuantizer(centroid_hnsw, nsub, pqp)

        # quantize the corpus in streaming chunks (reference: vector_chunks,
        # src/pq.rs:325-334)
        n = full_source.count
        if host:
            chunks = (host_rows(c, device) for c in full_source.chunks(chunk_size))
        else:
            chunks = (vectors[start : start + chunk_size] for start in range(0, n, chunk_size))
        codes = []
        with TRACER.span("pq_quantize", sync=sync, n=n):
            for chunk in chunks:
                monitor.alive()
                codes.append(quantizer.quantize(chunk, exact=exact_quantize, fast=fast_quantize))
        codes = torch.cat(codes)
        if code_dtype is None:
            code_dtype = code_dtype_for(centroids.shape[-2])
        codes = narrow_codes(codes) if code_dtype == torch.uint16 else codes.to(code_dtype)
        pq_source = PqSource(codes=codes, codebook=centroids)
        if not build_graph:
            return cls(quantizer, Hnsw([], pq_source, metric, pqp.hnsw, verbose=verbose), full_source)

        with TRACER.span("pq_code_graph", sync=sync, n=n):
            hnsw = Hnsw.generate(
                pq_source, None, pqp.hnsw, metric, seed=seed, progress=monitor, verbose=verbose
            )
        return cls(quantizer, hnsw, full_source)

    @property
    def vector_count(self) -> int:
        """Rows in the index: the code graph's bottom layer, or every code of
        a scan-only index."""
        return self.hnsw.vector_count if self.hnsw.layers else self.hnsw.source.count

    def _check_graph(self, what: str) -> None:
        if not self.hnsw.layers:
            raise ValueError(f"scan-only index (build_graph=False) has no code graph {what}")

    def centroid_hnsw(self) -> Optional[Hnsw]:
        """The centroid graph (shared-codebook quantizer only; a
        :class:`SubspaceQuantizer` scans its codebooks and has no graph)."""
        return getattr(self.quantizer, "hnsw", None)

    def search(
        self,
        queries: torch.Tensor,
        sp: Optional[SearchParams] = None,
        rerank: bool = True,
        exact_quantize: bool = False,
        query_block: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize the query, search the code graph, exact-rerank
        (reference: src/pq.rs:346-364)."""
        self._check_graph("to search; query it with search_exact()")
        sp = sp or self.hnsw.build_parameters.optimization.search
        if query_block <= 0:
            # the JAX package's bound on the code-graph hop's reconstructed
            # [Q, beam*M, SIZE] block (lane-padded); kept so both cut the same
            # query blocks
            eff = source_effective_width(self.hnsw.source)
            query_block = max(64, min(8192, (2 << 30) // (sp.beam_width * 48 * eff * 4)))
        qcodes = self.quantizer.quantize(queries, exact=exact_quantize)
        qrecon = self.quantizer.reconstruct(qcodes)
        # when this method reranks against the full vectors anyway, a routed
        # code-graph traversal skips its own intermediate rerank
        ids, dists = self.hnsw.search(qrecon, sp, query_block=query_block, rerank_routed=not rerank)
        if not rerank:
            return ids, dists
        return self._rerank(queries, ids)

    def enable_routing(self, dr: Optional[int] = 64, seed: int = 0) -> None:
        """Routing-accelerated code-graph traversal (see
        :mod:`parallel_hnsw_tpu_torch.routing`): the hop scores narrow bf16
        routing rows instead of reconstructed codes."""
        self.hnsw.enable_routing(dr=dr, seed=seed)

    def enable_hop_slabs(self, byte_budget: int = 4 << 30) -> None:
        """Neighbor-major hop slabs for the code graph (see
        :class:`parallel_hnsw_tpu_torch.routing.HopSlabs`); call
        :meth:`enable_routing` first to shrink them.  The final exact rerank
        is unchanged."""
        self.hnsw.enable_hop_slabs(byte_budget=byte_budget)

    def _rerank(self, queries: torch.Tensor, ids: torch.Tensor, block_budget: int = 1 << 30):
        """Exact rerank of every returned candidate with the full-precision
        vectors, resorted by (distance, id) (reference: src/pq.rs:354-363).

        Traced as ``pq_rerank`` (``rows``: candidate rows gathered; ``host``:
        1 when the rows come from a host source), waiting for the card."""
        host = int(is_host_source(self.full_source))
        with TRACER.span("pq_rerank", sync=queries, rows=ids.numel(), host=host):
            return exact_rerank(self.full_source, self.hnsw.metric, queries, ids, block_budget)

    def search_exact(
        self,
        queries: torch.Tensor,
        k: int = 10,
        rerank: bool = True,
        code_block: int = 1 << 16,
        query_block: int = 4096,
        oversample: int = 4,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat scan over all codes + optional exact rerank.

        Each code block is decoded (``[block, D]``) and scanned against the
        query block: mathematically the ADC LUT sum (:func:`adc_scan`),
        gather-light and product-bound.  With ``rerank`` the fast (bf16)
        scan keeps ``oversample * k`` survivors per query and the exact
        full-precision rerank cuts back to ``k``; from 200k codes the scan is
        the binned kernel on blocks of >= 2^19 codes, below it the pairwise
        kernel (fast mode, or exact without ``rerank``): the choice of
        :func:`~parallel_hnsw_tpu_torch.flat.block_scan`.

        Each query block is traced as ``pq_scan``, waiting for the card:
        ``queries`` (rows of the block), ``code_blocks`` and ``decoded_rows``
        (code blocks decoded and scanned, and their rows), ``survivors``
        (survivor slots the block hands on: rows times ``oversample * k``)."""
        pq_src = self.hnsw.source
        if not isinstance(pq_src, PqSource):
            raise TypeError(f"the code graph's source is a {type(pq_src).__name__}, not a PqSource")
        n = pq_src.count
        mode, code_block = block_scan(n, rerank, code_block)

        def decode(start: int, stop: int) -> torch.Tensor:
            return reconstruct(pq_src.codebook, pq_src.codes[start:stop])

        ids, dists = blocked_scan(
            queries, decode, n, self.hnsw.metric, mode, k * oversample if rerank else k,
            code_block, query_block, cut=_cut_survivors,
            span=lambda q: TRACER.span("pq_scan", sync=q, queries=q.shape[0]),
        )
        if rerank:
            ids, dists = self._rerank(queries, ids)
        return ids[:, :k], dists[:, :k]

    # delegates (reference: src/pq.rs:366-410)
    def improve_index(self, bp: Optional[BuildParams] = None, last_recall=None) -> float:
        self._check_graph("to improve; build it with build_graph=True")
        return self.hnsw.improve_index(bp, last_recall)

    def improve_neighbors(self, op: Optional[OptimizationParams] = None, last_recall=None) -> float:
        self._check_graph("to improve; build it with build_graph=True")
        return self.hnsw.improve_neighbors(op, last_recall)

    def promote_at_layer(self, layer_from_top: int, bp: Optional[BuildParams] = None) -> bool:
        self._check_graph("to promote in; build it with build_graph=True")
        return self.hnsw.promote_at_layer(layer_from_top, bp)

    def stochastic_recall(self, op: Optional[OptimizationParams] = None) -> float:
        self._check_graph("to sample recall from; build it with build_graph=True")
        return self.hnsw.stochastic_recall(op)

    def threshold_nn(self, threshold: float, probe_depth: int = 2, initial_search_depth=None):
        self._check_graph("to walk; build it with build_graph=True")
        return self.hnsw.threshold_nn(threshold, probe_depth, initial_search_depth)

    def zero_neighborhood_size(self) -> int:
        return self.hnsw.build_parameters.zero_layer_neighborhood_size

    def build_parameters_for_improve_index(self) -> BuildParams:
        return self.hnsw.build_parameters
