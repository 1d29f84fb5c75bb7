"""Graph data model: dense tensors instead of pointer-chasing
(counterpart of ``parallel_hnsw_tpu.graph``).

Per layer

* ``nodes  [N]    int32`` — sorted vector ids (ascending)
* ``neighbors [N, M] int32`` — node-id rows, ``EMPTY_ID``-padded

plus a *vector source* that gathers feature vectors for ids: a
:class:`DenseSource` or a :class:`PqSource` (codes + codebook) on a device,
or a :class:`MemmapSource` (f32 rows on the host, out of core).  Every tensor
of an index lives on its device source's device.  The functions that take a
source (:func:`source_get`, :func:`source_distance`,
:func:`source_effective_width`, :func:`materialize_source`) dispatch on its
type.  A storage type of the user's registers :func:`source_get` alone (the
reference's ``Comparator`` trait, src/lib.rs:53-74); the other three then
take their defaults, which are built on it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.ops.cuda_gather import gather_distance, row_gather
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance
from parallel_hnsw_tpu_torch.utils import device as _device


class Layer(NamedTuple):
    """One graph level. ``neighbors.shape == (len(nodes), M)``."""

    nodes: torch.Tensor  # [N] int32, sorted vector ids
    neighbors: torch.Tensor  # [N, M] int32 node ids, EMPTY_ID-padded

    @property
    def node_count(self) -> int:
        return self.nodes.shape[0]

    @property
    def neighborhood_size(self) -> int:
        return self.neighbors.shape[1]


class DenseSource(NamedTuple):
    """All vectors resident on the device as one ``[V, D]`` f32 tensor."""

    vectors: torch.Tensor  # [V, D] float32

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def count(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


class PqSource(NamedTuple):
    """PQ-compressed vectors: per-id codes plus a codebook.

    The codebook is either shared across subspaces, ``[K, Dsub]`` (the
    reference's design, src/pq.rs:29-82), or per-subspace ``[Q, K, Dsub]``
    (classic PQ).  Codes are ``uint16`` when K <= 65536 (the reference's u16
    codes, src/pq.rs:20), else int32; they are widened to int32 only for a
    gather (:func:`widen_codes`).  :func:`source_get` reconstructs full
    vectors by codebook gather."""

    codes: torch.Tensor  # [V, Q] uint16 or int32 centroid ids per subspace
    codebook: torch.Tensor  # [K, Dsub] shared or [Q, K, Dsub] per-subspace, f32

    @property
    def dim(self) -> int:
        if self.codebook.dim() == 2:
            return self.codes.shape[1] * self.codebook.shape[1]
        return self.codebook.shape[0] * self.codebook.shape[2]

    @property
    def count(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device


class MemmapSource(NamedTuple):
    """Host-resident dense f32 vectors (``np.memmap`` or ``np.ndarray``) that
    are NEVER moved to a device as a whole: the out-of-core source
    (reference: ``VectorSelector`` / ``VectorStore``, src/pq.rs:133-142,
    streamed at src/pq.rs:325-334).  Consumers move rows host -> device in
    bounded pieces: :meth:`chunks` for quantization and scans,
    :func:`source_get` (a host gather, then one copy) for rerank rows.  It
    has no device of its own: whoever gathers from it names one."""

    vectors: "np.memmap | np.ndarray"  # host [V, D] float32

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def count(self) -> int:
        return self.vectors.shape[0]

    def chunks(self, chunk_size: int = 100_000, ids=None):
        """Yield host f32 chunks ``[<= chunk_size, D]``, of every row in order
        or of the rows ``ids`` (any integer array, in its order): host memory
        stays bounded by one chunk whatever the corpus size."""
        if ids is None:
            for start in range(0, self.count, chunk_size):
                yield np.asarray(self.vectors[start : start + chunk_size])
        else:
            ids = np.asarray(ids)
            for start in range(0, len(ids), chunk_size):
                yield np.asarray(self.vectors[ids[start : start + chunk_size]])


def open_memmap_source(path: str, dim: int, dtype="float32") -> MemmapSource:
    """Open a raw row-major ``[*, dim]`` file as a MemmapSource (read-only)."""
    mm = np.memmap(path, dtype=dtype, mode="r")
    return MemmapSource(vectors=mm.reshape(mm.shape[0] // dim, dim))


def host_rows(rows: np.ndarray, device) -> torch.Tensor:
    """Host rows (a chunk or a gather of a memmap) as one f32 tensor on
    ``device``; rows that are a read-only view of the file are copied first
    (torch takes no read-only arrays)."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    return torch.from_numpy(rows if rows.flags.writeable else rows.copy()).to(device)


def is_host_source(source) -> bool:
    """True when the source's storage lives on the host (out of core)."""
    return isinstance(source, MemmapSource)


Source = Union[DenseSource, PqSource, MemmapSource]


def widen_codes(codes: torch.Tensor) -> torch.Tensor:
    """PQ codes as int32.  ``uint16`` codes go through their int16 bit
    pattern: torch gives ``uint16`` storage, views and copies, and little
    arithmetic."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).to(torch.int32) & 0xFFFF
    return codes.to(torch.int32)


def narrow_codes(codes: torch.Tensor) -> torch.Tensor:
    """int32 codes in ``[0, 65536)`` as ``uint16`` (through int16, which
    keeps the low 16 bits)."""
    return codes.to(torch.int16).view(torch.uint16)


@functools.singledispatch
def source_get(source, ids: torch.Tensor) -> torch.Tensor:
    """Gather feature vectors for ``ids`` (any shape) -> ``[*ids.shape, D]``.

    Ids are clipped into range (the row-gather kernel does not check them);
    EMPTY_ID gathers a real row, so callers mask distances of invalid slots
    to +inf.

    The extension seam, as in the JAX package: register a custom storage
    with ``@source_get.register`` on a type that exposes ``dim``, ``count``
    and ``device`` (where its rows live; the JAX package needs no device).
    :func:`source_distance`, :func:`source_effective_width` and
    :func:`materialize_source` take defaults built on this function for any
    type that registered nothing with them; a type unknown here raises, in
    those three too."""
    raise TypeError(f"unknown source type {type(source)}")


@source_get.register
def _(source: DenseSource, ids: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(ids, 0, source.vectors.shape[0] - 1).to(ID_DTYPE)
    return row_gather(source.vectors, safe)


@source_get.register
def _(source: PqSource, ids: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(ids, 0, source.count - 1).to(ID_DTYPE)
    return reconstruct(source.codebook, row_gather(source.codes, safe))


@source_get.register
def _(source: MemmapSource, ids, device=None) -> torch.Tensor:
    """Host gather (numpy fancy indexing of the clipped ids), then ONE copy
    of the ``[*ids.shape, D]`` rows to ``device`` (default: the ids' device
    when they are a tensor, else the card)."""
    if device is None:
        device = ids.device if isinstance(ids, torch.Tensor) else _device.resolve_device(None)
    host_ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    idx = np.clip(host_ids, 0, source.count - 1)
    return host_rows(source.vectors[idx.ravel()].reshape(idx.shape + (source.dim,)), device)


def reconstruct(codebook: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Decode PQ codes ``[*, Q]`` -> vectors ``[*, Q*Dsub]`` by one row gather
    of centroids (reference: Quantizer::reconstruct, src/pq.rs:73-81).  A
    shared ``[K, Dsub]`` codebook is indexed by the codes; a per-subspace
    ``[Q, K, Dsub]`` one as the table ``[Q*K, Dsub]`` at ``j*K + code``.
    Codes are clipped into ``[0, K)``, as the JAX package does."""
    nsub = codes.shape[-1]
    codes = widen_codes(codes)
    if codebook.dim() == 2:
        k, dsub = codebook.shape
        idx = torch.clamp(codes, 0, k - 1)
        table = codebook
    else:
        nsub_b, k, dsub = codebook.shape
        if nsub_b != nsub:
            raise ValueError(f"codes of {nsub} subspaces against a codebook of {nsub_b}")
        offsets = torch.arange(nsub, dtype=torch.int32, device=codes.device) * k
        idx = torch.clamp(codes, 0, k - 1) + offsets
        table = codebook.reshape(nsub * k, dsub)
    sub = row_gather(table.contiguous(), idx)  # [*, Q, Dsub]
    return sub.reshape(*codes.shape[:-1], nsub * dsub)


def _known(source) -> None:
    """Raise as :func:`source_get` does for a type that registered nothing
    with it: the defaults below are built on it."""
    if source_get.dispatch(type(source)) is source_get.dispatch(object):
        raise TypeError(f"unknown source type {type(source)}")


def _gathered_distance(source, queries, ids, metric, **device):
    inside = (ids >= 0) & (ids < source.count)
    rows = source_get(source, torch.where(inside, ids, 0), **device)
    return torch.where(inside, batched_distance(queries, rows, metric), float("inf"))


@functools.singledispatch
def source_distance(
    source, queries: torch.Tensor, ids: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """Distances ``[Q, K]`` of ``queries [Q, D]`` to the feature vectors of
    ``ids [Q, K]`` int32: ``batched_distance(queries, source_get(source,
    ids))`` where an id is a vector of the source, ``+inf`` where it is not
    (``EMPTY_ID``).

    That pair is the default, which a :class:`PqSource` that
    ``Hnsw.compute_source`` did not densify takes (it reconstructs the rows)
    and so does any source type of the user's.  The rows of a dense source
    are one tensor, so the gather and the distances are one kernel on the
    card (:func:`~parallel_hnsw_tpu_torch.ops.cuda_gather.gather_distance`):
    the gathered rows never reach device memory.  A :class:`MemmapSource`
    gathers its rows on the host and copies them to the queries' device."""
    _known(source)
    return _gathered_distance(source, queries, ids, metric)


@source_distance.register
def _(source: DenseSource, queries, ids, metric):
    return gather_distance(queries, source.vectors, ids, metric)


@source_distance.register
def _(source: MemmapSource, queries, ids, metric):
    return _gathered_distance(source, queries, ids, metric, device=queries.device)


@functools.singledispatch
def source_effective_width(source) -> int:
    """Bytes-per-vector proxy for block-size budgeting.  The JAX package pads
    every gathered row to 128 lanes, kept here so both packages cut the same
    blocks: ``max(dim, 128)``, the default for every source type but
    :class:`PqSource`, whose reconstruction gathers ``[*, Dsub]`` rows, each
    padded to 128."""
    _known(source)
    return max(source.dim, 128)


@source_effective_width.register
def _(source: PqSource) -> int:
    if source.codebook.dim() == 2:
        nsub, dsub = source.codes.shape[1], source.codebook.shape[1]
    else:
        nsub, _, dsub = source.codebook.shape
    return nsub * max(dsub, 128)


@functools.singledispatch
def materialize_source(source, block: int = 16384, device=None) -> torch.Tensor:
    """The source as a dense f32 ``[N, D]`` tensor: a DenseSource as it is
    (no copy), a MemmapSource copied in row blocks to ``device`` (default: the
    card; this puts the whole corpus on it, as the JAX package's does), any
    other source (a PqSource, a type of the user's) gathered in row blocks
    through :func:`source_get` on its own device."""
    _known(source)
    ids = torch.arange(source.count, dtype=ID_DTYPE, device=source.device)
    return gather_features(source, ids, block)


@materialize_source.register
def _(source: DenseSource, block: int = 16384, device=None) -> torch.Tensor:
    return source.vectors


@materialize_source.register
def _(source: MemmapSource, block: int = 16384, device=None) -> torch.Tensor:
    device = _device.resolve_device(device)
    return torch.cat([host_rows(c, device) for c in source.chunks(block)])


def gather_features(source: Source, ids: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """source_get in row blocks for 1-D id tensors (bounds the transient
    codes and centroid rows of a PQ reconstruction)."""
    n = ids.shape[0]
    if n <= block:
        return source_get(source, ids)
    return torch.cat([source_get(source, ids[s : s + block]) for s in range(0, n, block)])


def vec_to_node(nodes: torch.Tensor, vids: torch.Tensor) -> torch.Tensor:
    """Map vector ids to node ids via binary search on the sorted ``nodes``.

    Reference: ``Layer::get_node`` (src/lib.rs:129-131).  Unknown / EMPTY ids
    map to EMPTY_ID.
    """
    n = nodes.shape[0]
    pos = torch.searchsorted(nodes, vids.contiguous())
    safe = torch.clamp(pos, 0, n - 1)
    found = (pos < n) & (nodes[safe] == vids) & (vids != EMPTY_ID)
    return torch.where(found, pos, EMPTY_ID).to(ID_DTYPE)


def node_to_vec(nodes: torch.Tensor, nids: torch.Tensor) -> torch.Tensor:
    """Map node ids back to vector ids (reference: Layer::get_vector)."""
    n = nodes.shape[0]
    out = nodes[torch.clamp(nids, 0, n - 1)]
    return torch.where(nids == EMPTY_ID, EMPTY_ID, out).to(ID_DTYPE)


def make_layer(nodes, neighbors, device=None) -> Layer:
    return Layer(
        nodes=torch.as_tensor(np.array(nodes), dtype=ID_DTYPE, device=device),
        neighbors=torch.as_tensor(np.array(neighbors), dtype=ID_DTYPE, device=device),
    )


def assert_layer_invariants(layers: Sequence[Layer]) -> None:
    """Host-side invariant check (reference: src/search.rs:142-171): layer
    nodes strictly ascending, and every node present in the layer below."""
    for i in range(len(layers)):
        nodes = layers[i].nodes.cpu().numpy()
        if not np.all(np.diff(nodes) > 0):
            raise AssertionError(f"layer {i} nodes not strictly ascending")
        if i + 1 < len(layers):
            below = layers[i + 1].nodes.cpu().numpy()
            missing = np.setdiff1d(nodes, below)
            if missing.size:
                raise AssertionError(
                    f"layer {i} nodes missing from layer {i+1}: {missing[:10]}"
                )
