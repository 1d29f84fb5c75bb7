"""Index persistence: directory format with pinned dtypes (counterpart of
``parallel_hnsw_tpu.io``).

Same layout as the JAX package (and, in shape, the reference's
src/serialize.rs:33-209), so either package reads what the other wrote:
``meta`` JSON with layer_count + build parameters, per-layer
``layer.meta.{n}`` JSON and raw ``layer.nodes.{n}`` / ``layer.neighbors.{n}``
dumps (numbered from the *bottom*), plus a ``comparator/`` directory for the
vector store.  All arrays are little-endian int32/float32, PQ codes
``uint16`` or int32 as stored.  A quantized index nests ``quantizer/``,
``hnsw/`` and ``comparator/`` (reference: src/pq.rs:433-452); a sharded
index one ``shard.{s}/`` per shard, a sharded quantized one ``quantizer/``,
``sharded/`` and its in-core rows (out of core, the memmap is the user's
store and is not written).

Every ``deserialize_*`` takes a ``device`` and places what it reads there
(``None``: the card, :func:`parallel_hnsw_tpu_torch.utils.device.default_device`);
the sharded ones take the mesh, whose devices say where each shard goes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource, Layer, PqSource, Source, is_host_source
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import (
    build_params_from_dict,
    params_to_dict,
    pq_build_params_from_dict,
)
from parallel_hnsw_tpu_torch.pq import HnswQuantizer, QuantizedHnsw, SubspaceQuantizer
from parallel_hnsw_tpu_torch.utils import device as _device

FORMAT_VERSION = 1


class SerializationError(Exception):
    pass


class IndexNotFound(SerializationError):
    """Missing comparator directory (reference: serialize.rs:143-146)."""


def to_numpy(arr: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; ``uint16`` through its int16 bits."""
    arr = arr.detach()
    if arr.dtype == torch.uint16:  # viewed before the copy: copies of uint16 are few
        return arr.view(torch.int16).cpu().numpy().view(np.uint16)
    return arr.cpu().numpy()


def from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """:func:`to_numpy` backwards, onto ``device``."""
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)
    return torch.from_numpy(arr).to(device)


def _write_array(path: Path, arr: torch.Tensor, dtype: str) -> None:
    host = to_numpy(arr)
    np.ascontiguousarray(host.astype(np.dtype(dtype).newbyteorder("<"))).tofile(path)


def _read_array(path: Path, dtype: str, shape, device: torch.device) -> torch.Tensor:
    arr = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<")).reshape(shape)
    return from_numpy(arr.astype(dtype, copy=False), device)


# -- source (comparator) serialization --------------------------------------


def serialize_source(source: Source, path: Union[str, Path]) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if isinstance(source, DenseSource):
        count, dim = source.vectors.shape
        meta = {"kind": "dense", "count": count, "dim": dim}
        _write_array(path / "vectors", source.vectors, "float32")
    elif isinstance(source, PqSource):
        code_dtype = str(source.codes.dtype).replace("torch.", "")
        meta = {
            "kind": "pq",
            "count": source.codes.shape[0],
            "nsub": source.codes.shape[1],
            "code_dtype": code_dtype,
            "codebook_shape": list(source.codebook.shape),  # [K, dsub] or [Q, K, dsub]
        }
        _write_array(path / "codes", source.codes, code_dtype)
        _write_array(path / "codebook", source.codebook, "float32")
    elif is_host_source(source):
        # the user's store, as the reference's comparator (src/lib.rs:76-83):
        # an out-of-core index records where it is, not its rows
        raise SerializationError(
            "a host (out-of-core) source is an external store: it is not written"
        )
    else:
        raise SerializationError(f"unknown source type {type(source)}")
    (path / "meta").write_text(json.dumps(meta))


def deserialize_source(path: Union[str, Path], device=None) -> Source:
    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    device = _device.resolve_device(device)
    if meta["kind"] == "dense":
        vec = _read_array(path / "vectors", "float32", (meta["count"], meta["dim"]), device)
        return DenseSource(vectors=vec)
    if meta["kind"] == "pq":
        dt = meta.get("code_dtype", "int32")
        if dt not in ("uint16", "int32"):
            raise SerializationError(f"unknown PQ code dtype {dt}")
        codes = _read_array(path / "codes", dt, (meta["count"], meta["nsub"]), device)
        book = _read_array(path / "codebook", "float32", tuple(meta["codebook_shape"]), device)
        return PqSource(codes=codes, codebook=book)
    raise SerializationError(f"unknown source kind {meta['kind']}")


# -- hnsw serialization ------------------------------------------------------


def serialize_hnsw(
    hnsw: Hnsw,
    path: Union[str, Path],
    store_source: bool = True,
    extra_meta: Optional[dict] = None,
) -> None:
    """reference: serialize_hnsw (serialize.rs:33-124)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    layer_count = hnsw.layer_count

    # invalidate any previous meta up front: a crash mid-overwrite must not
    # leave stale meta that blesses a mix of old/new/truncated layer files
    meta_path = path / "meta"
    if meta_path.exists():
        meta_path.unlink()

    if store_source:
        serialize_source(hnsw.source, path / "comparator")

    for i, layer in enumerate(hnsw.layers):
        layer_number = layer_count - i - 1  # numbered from the bottom like the reference
        (path / f"layer.meta.{layer_number}").write_text(
            json.dumps(
                {
                    "node_count": layer.node_count,
                    "neighborhood_size": layer.neighborhood_size,
                }
            )
        )
        _write_array(path / f"layer.nodes.{layer_number}", layer.nodes, "int32")
        _write_array(path / f"layer.neighbors.{layer_number}", layer.neighbors, "int32")

    # meta is written LAST so an interrupted serialization (crash mid-layer)
    # never leaves a directory that passes the "meta exists" completeness
    # check checkpoint consumers rely on
    meta = {
        "format_version": FORMAT_VERSION,
        "layer_count": layer_count,
        "metric": hnsw.metric.value,
        "build_parameters": params_to_dict(hnsw.build_parameters),
    }
    if extra_meta:
        meta.update(extra_meta)
    meta_path.write_text(json.dumps(meta))


def read_index_meta(path: Union[str, Path]) -> dict:
    """Read the index meta JSON (raises if absent/incomplete)."""
    return json.loads((Path(path) / "meta").read_text())


def deserialize_hnsw(
    path: Union[str, Path], source: Optional[Source] = None, device=None
) -> Hnsw:
    """reference: deserialize_hnsw (serialize.rs:126-209).  If ``source`` is
    None the comparator directory must exist.  The layers go to ``device``
    (``None``: the given source's device, else the card)."""
    path = Path(path)
    meta = read_index_meta(path)
    layer_count = meta["layer_count"]
    bp = build_params_from_dict(meta["build_parameters"])
    metric = Metric(meta["metric"])

    if source is None:
        if not (path / "comparator").exists():
            raise IndexNotFound(str(path))
        source = deserialize_source(path / "comparator", device)
    elif device is None:
        device = source.device
    device = _device.resolve_device(device)

    layers = []
    for i in range(layer_count):
        layer_number = layer_count - i - 1
        lm = json.loads((path / f"layer.meta.{layer_number}").read_text())
        nodes = _read_array(
            path / f"layer.nodes.{layer_number}", "int32", (lm["node_count"],), device
        )
        neighbors = _read_array(
            path / f"layer.neighbors.{layer_number}",
            "int32",
            (lm["node_count"], lm["neighborhood_size"]),
            device,
        )
        layers.append(Layer(nodes=nodes, neighbors=neighbors))
    return Hnsw(layers, source, metric, bp)


# -- quantized hnsw (reference: src/pq.rs:413-477) ---------------------------


def _serialize_quantizer(quantizer, path: Path) -> None:
    """Persist either quantizer kind under ``quantizer/``: an HnswQuantizer
    as its centroid graph (reference: src/pq.rs:433-441), a
    SubspaceQuantizer as its raw ``[nsub, K, dsub]`` codebooks with a
    ``quantizer_kind`` tag."""
    path = Path(path)
    if isinstance(quantizer, SubspaceQuantizer):
        path.mkdir(parents=True, exist_ok=True)
        _write_array(path / "codebooks", quantizer.codebooks, "float32")
        (path / "pq_build_parameters.json").write_text(
            json.dumps(
                {
                    "quantizer_kind": "subspace",
                    "codebooks_shape": list(quantizer.codebooks.shape),
                    "metric": quantizer.metric.value,
                    "pq_params": params_to_dict(quantizer.pq_params),
                }
            )
        )
        return
    serialize_hnsw(quantizer.hnsw, path)
    (path / "pq_build_parameters.json").write_text(
        json.dumps({"nsub": quantizer.nsub, "pq_params": params_to_dict(quantizer.pq_params)})
    )


def _deserialize_quantizer(path: Path, device: torch.device):
    path = Path(path)
    qmeta = json.loads((path / "pq_build_parameters.json").read_text())
    pqp = pq_build_params_from_dict(qmeta["pq_params"])
    if qmeta.get("quantizer_kind") == "subspace":
        books = _read_array(path / "codebooks", "float32", tuple(qmeta["codebooks_shape"]), device)
        return SubspaceQuantizer(books, Metric(qmeta["metric"]), pqp)
    return HnswQuantizer(deserialize_hnsw(path, device=device), qmeta["nsub"], pqp)


def serialize_quantized_hnsw(q: QuantizedHnsw, path: Union[str, Path]) -> None:
    """Nested layout: quantizer/, hnsw/, comparator/ (reference:
    src/pq.rs:433-452)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    _serialize_quantizer(q.quantizer, path / "quantizer")
    serialize_hnsw(q.hnsw, path / "hnsw")
    serialize_source(q.full_source, path / "comparator")


def deserialize_quantized_hnsw(path: Union[str, Path], device=None) -> QuantizedHnsw:
    """A quantized index read onto ``device`` (``None``: the card)."""
    path = Path(path)
    device = _device.resolve_device(device)
    quantizer = _deserialize_quantizer(path / "quantizer", device)
    hnsw = deserialize_hnsw(path / "hnsw", device=device)
    full_source = deserialize_source(path / "comparator", device)
    return QuantizedHnsw(quantizer, hnsw, full_source)


# -- sharded hnsw -------------------------------------------------------------
# The layout extends the directory format (reference: serialize.rs:33-209)
# with per-shard subdirectories, as the JAX package writes it: each shard is
# the standard Hnsw layout (its padded source as the comparator) plus
# ``global_ids``.


def serialize_sharded_hnsw(sh, path: Union[str, Path]) -> None:
    """Per-shard subdirs ``shard.{s}/`` under a top-level ``meta`` with mesh
    info."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "sharded_hnsw",
        "n_shards": sh.n_shards,
        "axis": sh.axis,
        "metric": sh.metric.value,
        "build_parameters": params_to_dict(sh.build_parameters),
    }
    (path / "meta").write_text(json.dumps(meta))
    for s in range(sh.n_shards):
        sdir = path / f"shard.{s}"
        serialize_hnsw(sh._shard_hnsw(s), sdir, store_source=True)
        gids = sh.shard_global_ids(s)
        _write_array(sdir / "global_ids", gids, "int32")
        (sdir / "shard.meta").write_text(json.dumps({"rows": int(gids.shape[0])}))


def deserialize_sharded_hnsw(path: Union[str, Path], mesh):
    """A ShardedHnsw on ``mesh`` (runtime state the caller supplies; its
    size must be the index's shard count), each shard read onto its mesh
    device."""
    from parallel_hnsw_tpu_torch.parallel.sharded import ShardedHnsw

    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    if meta.get("kind") != "sharded_hnsw":
        raise SerializationError(f"not a sharded index: {path}")
    n_shards = meta["n_shards"]
    if mesh.devices.size != n_shards:
        raise SerializationError(
            f"mesh has {mesh.devices.size} devices but index has {n_shards} shards"
        )
    bp = build_params_from_dict(meta["build_parameters"])
    metric = Metric(meta["metric"])
    shard_hnsws, gids = [], []
    for s, dev in enumerate(mesh.devices.flat):
        sdir = path / f"shard.{s}"
        shard_hnsws.append(deserialize_hnsw(sdir, device=dev))
        rows = json.loads((sdir / "shard.meta").read_text())["rows"]
        gids.append(_read_array(sdir / "global_ids", "int32", (rows,), dev))
    out = ShardedHnsw._from_shards(
        mesh, [[] for _ in shard_hnsws], [h.source for h in shard_hnsws], gids, metric, bp
    )
    if shard_hnsws[0].layer_count:
        out._restack_from_hnsws(shard_hnsws)
    return out


def serialize_sharded_quantized_hnsw(sq, path: Union[str, Path]) -> None:
    """Nested layout (reference: src/pq.rs:433-452): ``quantizer/`` +
    ``sharded/`` + the stacked in-core rows in ``full``, written shard by
    shard.  Out of core the rows are the user's store: ``meta`` records
    their width and, for a memmap, its file as a reload hint."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    out_of_core = sq.full_host is not None
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "sharded_quantized_hnsw",
        "nsub": sq.quantizer.nsub,
        "out_of_core": out_of_core,
    }
    n = sq.sharded.n_shards
    if out_of_core:
        meta["full_dim"] = int(sq.full_host.dim)
        filename = getattr(sq.full_host.vectors, "filename", None)
        if filename:
            meta["full_path"] = str(filename)
    else:
        meta["full_shape"] = [n, *sq.shard_full(0).shape]
    (path / "meta").write_text(json.dumps(meta))
    _serialize_quantizer(sq.quantizer, path / "quantizer")
    serialize_sharded_hnsw(sq.sharded, path / "sharded")
    if not out_of_core:
        with open(path / "full", "wb") as f:
            for s in range(n):
                f.write(np.ascontiguousarray(to_numpy(sq.shard_full(s)), "<f4").tobytes())


def deserialize_sharded_quantized_hnsw(path: Union[str, Path], mesh, full_source=None):
    """A ShardedQuantizedHnsw on ``mesh``: the quantizer on its first device,
    each shard (and its in-core rows) on its own.  Out of core the rows are
    external: ``full_source`` (a MemmapSource), else the recorded memmap
    file; neither raises (reference: a missing store is IndexNotFound,
    src/serialize.rs:143-146)."""
    from parallel_hnsw_tpu_torch.graph import open_memmap_source
    from parallel_hnsw_tpu_torch.parallel.sharded import ShardedQuantizedHnsw

    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    if meta.get("kind") != "sharded_quantized_hnsw":
        raise SerializationError(f"not a sharded PQ index: {path}")
    quantizer = _deserialize_quantizer(path / "quantizer", mesh.devices.flat[0])
    sharded = deserialize_sharded_hnsw(path / "sharded", mesh)
    if meta.get("out_of_core"):
        if full_source is None:
            hint = meta.get("full_path")
            if not hint or not Path(hint).exists():
                raise SerializationError(
                    "out-of-core index: pass full_source= (the vector store "
                    "is external, like the reference's comparator — "
                    "src/serialize.rs:143-146)"
                )
            full_source = open_memmap_source(hint, meta["full_dim"])
        return ShardedQuantizedHnsw(quantizer, sharded, full_host=full_source)
    n, per, dim = meta["full_shape"]
    full = np.memmap(path / "full", dtype="<f4", mode="r", shape=(n, per, dim))
    rows = [from_numpy(np.array(full[s], np.float32), dev) for s, dev in enumerate(mesh.devices.flat)]
    return ShardedQuantizedHnsw(quantizer, sharded, rows)
