"""Index persistence: directory format with pinned dtypes (counterpart of the
dense part of ``parallel_hnsw_tpu.io``).

Same layout as the JAX package (and, in shape, the reference's
src/serialize.rs:33-209), so either package reads what the other wrote:
``meta`` JSON with layer_count + build parameters, per-layer
``layer.meta.{n}`` JSON and raw ``layer.nodes.{n}`` / ``layer.neighbors.{n}``
dumps (numbered from the *bottom*), plus a ``comparator/`` directory for the
vector store.  All arrays are little-endian int32/float32.

Every ``deserialize_*`` takes a ``device`` and places what it reads there
(``None``: the card, :func:`parallel_hnsw_tpu_torch.utils.device.default_device`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource, Layer, Source
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import build_params_from_dict, params_to_dict
from parallel_hnsw_tpu_torch.utils import device as _device

FORMAT_VERSION = 1


class SerializationError(Exception):
    pass


class IndexNotFound(SerializationError):
    """Missing comparator directory (reference: serialize.rs:143-146)."""


def _write_array(path: Path, arr: torch.Tensor, dtype: str) -> None:
    host = arr.detach().cpu().numpy()
    np.ascontiguousarray(host.astype(np.dtype(dtype).newbyteorder("<"))).tofile(path)


def _read_array(path: Path, dtype: str, shape, device: torch.device) -> torch.Tensor:
    arr = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<")).reshape(shape)
    return torch.from_numpy(arr.astype(dtype, copy=False)).to(device)


# -- source (comparator) serialization --------------------------------------


def serialize_source(source: Source, path: Union[str, Path]) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if not isinstance(source, DenseSource):
        raise SerializationError(f"unknown source type {type(source)}")
    count, dim = source.vectors.shape
    _write_array(path / "vectors", source.vectors, "float32")
    (path / "meta").write_text(json.dumps({"kind": "dense", "count": count, "dim": dim}))


def deserialize_source(path: Union[str, Path], device=None) -> Source:
    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    if meta["kind"] == "dense":
        vec = _read_array(
            path / "vectors", "float32", (meta["count"], meta["dim"]),
            _device.resolve_device(device),
        )
        return DenseSource(vectors=vec)
    if meta["kind"] == "pq":
        raise SerializationError("a PQ source cannot be read yet: PQ is not ported")
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
