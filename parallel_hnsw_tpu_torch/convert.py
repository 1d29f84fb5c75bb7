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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource, make_layer
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import build_params_from_dict, params_to_dict
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
