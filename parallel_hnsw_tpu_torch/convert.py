"""Carry an index's state across packages as numpy arrays.

``hnsw_from_numpy`` builds the port's :class:`Hnsw` from the arrays of an
index of either package — for a JAX index::

    layers = [(np.asarray(l.nodes), np.asarray(l.neighbors)) for l in jax_hnsw.layers]
    hnsw = hnsw_from_numpy(layers, np.asarray(jax_hnsw.source.vectors),
                           jax_hnsw.metric.value,
                           params_to_dict(jax_hnsw.build_parameters), "cuda")

and ``hnsw_to_numpy`` gives back the same four arguments, so both packages
can be run on one identical graph.  ``routing_to_numpy`` /
``routing_from_numpy`` do the same for a routing cache, whose bf16 rows
travel as their uint16 bit patterns (numpy has no bfloat16) — for a JAX
cache ``np.asarray(cache.rows).view(np.uint16)``.

``quantized_to_numpy`` / ``quantized_from_numpy`` carry a
:class:`~parallel_hnsw_tpu_torch.pq.QuantizedHnsw` the same way, as one dict
of numpy arrays and plain values.  ``quantized_to_numpy`` reads only
attributes the two packages share and turns arrays with ``np.asarray``, so it
takes a JAX ``QuantizedHnsw`` as well::

    q = quantized_from_numpy(quantized_to_numpy(jax_quantized), "cuda")

``sharded_to_numpy`` / ``sharded_from_numpy`` and
``sharded_quantized_to_numpy`` / ``sharded_quantized_from_numpy`` carry a
sharded index's stacked arrays the same way (a JAX ``ShardedHnsw`` too); the
caller gives the mesh, and the memmap of an out-of-core index.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource, Layer, PqSource, make_layer
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.io import from_numpy, to_numpy
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import (
    build_params_from_dict,
    params_to_dict,
    pq_build_params_from_dict,
)
from parallel_hnsw_tpu_torch.pq import HnswQuantizer, QuantizedHnsw, SubspaceQuantizer
from parallel_hnsw_tpu_torch.routing import RoutingCache
from parallel_hnsw_tpu_torch.utils import device as _device


def hnsw_from_numpy(
    layers: Sequence[Tuple[np.ndarray, np.ndarray]],
    vectors: np.ndarray,
    metric,
    build_params: Dict[str, Any],
    device=None,
) -> Hnsw:
    """The port's index over ``layers`` (top→bottom ``(nodes, neighbors)``
    pairs) and the ``[V, D]`` corpus ``vectors``, all placed on ``device``
    (``None``: the card, :func:`utils.device.default_device`)."""
    device = _device.resolve_device(device)
    source = DenseSource(
        vectors=torch.as_tensor(np.asarray(vectors, dtype=np.float32), device=device)
    )
    return Hnsw(
        [make_layer(nodes, neighbors, device) for nodes, neighbors in layers],
        source,
        Metric(metric),
        build_params_from_dict(build_params),
    )


def hnsw_to_numpy(
    hnsw: Hnsw,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], np.ndarray, str, Dict[str, Any]]:
    """``(layers, vectors, metric, build_params)``, the arguments of
    :func:`hnsw_from_numpy`."""
    layers = [(l.nodes.cpu().numpy(), l.neighbors.cpu().numpy()) for l in hnsw.layers]
    return (
        layers,
        hnsw.source.vectors.cpu().numpy(),
        hnsw.metric.value,
        params_to_dict(hnsw.build_parameters),
    )


def routing_to_numpy(cache: RoutingCache) -> Tuple[Optional[np.ndarray], np.ndarray, str]:
    """``(projection f32 or None, rows as uint16 bit patterns, metric)``, the
    arguments of :func:`routing_from_numpy`."""
    projection = None if cache.projection is None else cache.projection.cpu().numpy()
    bits = cache.rows.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return projection, bits, cache.metric.value


def routing_from_numpy(
    projection: Optional[np.ndarray], rows_bits: np.ndarray, metric, device=None
) -> RoutingCache:
    """The port's routing cache from a ``[D, dr]`` f32 projection (or None),
    the ``[N, dr]`` uint16 bit patterns of its bf16 rows and the routed
    metric, placed on ``device`` (``None``: the card)."""
    device = _device.resolve_device(device)
    bits = np.array(rows_bits, dtype=np.uint16).view(np.int16)  # a copy torch may own
    return RoutingCache(
        projection=None
        if projection is None
        else torch.as_tensor(np.array(projection, dtype=np.float32), device=device),
        rows=torch.from_numpy(bits).to(device).view(torch.bfloat16),
        metric=Metric(metric),
    )


def _numpy(arr) -> np.ndarray:
    """A tensor of either package as numpy."""
    return to_numpy(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)


def _layers_to_numpy(hnsw) -> List[Tuple[np.ndarray, np.ndarray]]:
    return [(_numpy(l.nodes), _numpy(l.neighbors)) for l in hnsw.layers]


def _quantizer_to_numpy(quantizer) -> Dict[str, Any]:
    """A quantizer of either package: ``codebook``, the centroid graph's
    ``centroid_layers`` / ``centroid_build_params`` (``None`` for a
    per-subspace quantizer), ``nsub`` and ``pq_params``."""
    centroid = getattr(quantizer, "hnsw", None)
    return {
        "codebook": _numpy(quantizer.centroids if centroid is None else centroid.source.vectors),
        "centroid_layers": None if centroid is None else _layers_to_numpy(centroid),
        "centroid_build_params": None if centroid is None else params_to_dict(
            centroid.build_parameters),
        "nsub": int(quantizer.nsub),
        "pq_params": params_to_dict(quantizer.pq_params),
    }


def _quantizer_from_numpy(state: Dict[str, Any], metric: Metric, device: torch.device):
    """A shared ``[K, dsub]`` codebook becomes an :class:`HnswQuantizer` over
    the centroid graph, a ``[nsub, K, dsub]`` one a :class:`SubspaceQuantizer`."""
    codebook = from_numpy(np.array(state["codebook"], np.float32), device)
    pqp = pq_build_params_from_dict(state["pq_params"])
    if codebook.dim() == 3:
        return SubspaceQuantizer(codebook, metric, pqp)
    centroid = Hnsw(
        [make_layer(n, nb, device) for n, nb in state["centroid_layers"]],
        DenseSource(vectors=codebook), metric,
        build_params_from_dict(state["centroid_build_params"]),
    )
    return HnswQuantizer(centroid, int(state["nsub"]), pqp)


def quantized_to_numpy(q) -> Dict[str, Any]:
    """The state of a quantized index (of either package) as a dict:
    ``codes`` (``uint16`` or int32, as stored), ``codebook`` (``[K, dsub]``
    or ``[nsub, K, dsub]``), ``code_layers`` and ``build_params`` of the code
    graph, ``centroid_layers`` / ``centroid_build_params`` of the centroid
    graph (``None`` for a per-subspace quantizer), ``nsub``, ``vectors`` (the
    full-precision corpus), ``metric`` and ``pq_params``, the arguments of
    :func:`quantized_from_numpy`."""
    return {
        **_quantizer_to_numpy(q.quantizer),
        "codes": _numpy(q.hnsw.source.codes),
        "codebook": _numpy(q.hnsw.source.codebook),
        "code_layers": _layers_to_numpy(q.hnsw),
        "build_params": params_to_dict(q.hnsw.build_parameters),
        "nsub": int(q.hnsw.source.codes.shape[1]),
        "vectors": _numpy(q.full_source.vectors),
        "metric": q.hnsw.metric.value,
    }


def quantized_from_numpy(state: Dict[str, Any], device=None) -> QuantizedHnsw:
    """The port's :class:`QuantizedHnsw` from :func:`quantized_to_numpy`'s
    dict, placed on ``device`` (``None``: the card)."""
    device = _device.resolve_device(device)
    metric = Metric(state["metric"])
    quantizer = _quantizer_from_numpy(state, metric, device)
    codebook = quantizer.centroids if isinstance(quantizer, SubspaceQuantizer) else (
        quantizer.hnsw.source.vectors)
    code_graph = Hnsw(
        [make_layer(n, nb, device) for n, nb in state["code_layers"]],
        PqSource(codes=from_numpy(np.array(state["codes"]), device), codebook=codebook), metric,
        build_params_from_dict(state["build_params"]),
    )
    full = DenseSource(vectors=from_numpy(np.array(state["vectors"], np.float32), device))
    return QuantizedHnsw(quantizer, code_graph, full)


def sharded_to_numpy(sh) -> Dict[str, Any]:
    """The state of a sharded index (of either package) as a dict of its
    stacked arrays: ``layers`` (per level ``(nodes [S, N], neighbors
    [S, N, M])``), ``vectors`` ``[S, N, D]`` of a dense index or ``codes``
    ``[S, N, nsub]`` + ``codebook`` of a PQ one, ``global_ids`` ``[S, N]``,
    ``metric`` and ``build_params``: the arguments of
    :func:`sharded_from_numpy`."""
    src = sh.source_stacked
    out = {
        "layers": [(_numpy(l.nodes), _numpy(l.neighbors)) for l in sh.layers_stacked],
        "global_ids": _numpy(sh.global_ids),
        "metric": sh.metric.value,
        "build_params": params_to_dict(sh.build_parameters),
    }
    if hasattr(src, "codes"):
        out.update(codes=_numpy(src.codes), codebook=_numpy(src.codebook))
    else:
        out["vectors"] = _numpy(src.vectors)
    return out


def sharded_from_numpy(state: Dict[str, Any], mesh):
    """The port's :class:`~parallel_hnsw_tpu_torch.parallel.ShardedHnsw` on
    ``mesh`` from :func:`sharded_to_numpy`'s dict: each shard's slice on its
    mesh device."""
    from parallel_hnsw_tpu_torch.parallel.sharded import ShardedHnsw

    if "codes" in state:
        source = PqSource(codes=np.asarray(state["codes"]),
                          codebook=np.asarray(state["codebook"], np.float32))
    else:
        source = DenseSource(vectors=np.asarray(state["vectors"], np.float32))
    layers = [Layer(np.asarray(n, np.int32), np.asarray(nb, np.int32)) for n, nb in state["layers"]]
    return ShardedHnsw(mesh, layers, source, np.asarray(state["global_ids"], np.int32),
                       Metric(state["metric"]), build_params_from_dict(state["build_params"]))


def sharded_quantized_to_numpy(sq) -> Dict[str, Any]:
    """A sharded quantized index (of either package): the quantizer's fields
    (as :func:`quantized_to_numpy`'s), ``sharded`` (:func:`sharded_to_numpy`
    of its code index) and ``full`` (the in-core rows ``[S, N, D]``, ``None``
    out of core)."""
    full = sq.full_stacked
    return {
        **_quantizer_to_numpy(sq.quantizer),
        "sharded": sharded_to_numpy(sq.sharded),
        "full": None if full is None else _numpy(full),
    }


def sharded_quantized_from_numpy(state: Dict[str, Any], mesh, full_source=None):
    """The port's ShardedQuantizedHnsw on ``mesh`` from
    :func:`sharded_quantized_to_numpy`'s dict: the quantizer on the mesh's
    first device; out of core (``full`` is ``None``) over ``full_source``, a
    MemmapSource."""
    from parallel_hnsw_tpu_torch.parallel.sharded import ShardedQuantizedHnsw

    sharded = sharded_from_numpy(state["sharded"], mesh)
    quantizer = _quantizer_from_numpy(state, sharded.metric, mesh.devices.flat[0])
    if state["full"] is None:
        return ShardedQuantizedHnsw(quantizer, sharded, full_host=full_source)
    return ShardedQuantizedHnsw(quantizer, sharded, np.asarray(state["full"], np.float32))
