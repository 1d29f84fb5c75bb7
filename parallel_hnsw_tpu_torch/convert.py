"""Carry an index's state across packages as numpy arrays.

``hnsw_from_numpy`` builds the port's :class:`Hnsw` from the arrays of an
index of either package — for a JAX index::

    layers = [(np.asarray(l.nodes), np.asarray(l.neighbors)) for l in jax_hnsw.layers]
    hnsw = hnsw_from_numpy(layers, np.asarray(jax_hnsw.source.vectors),
                           jax_hnsw.metric.value,
                           params_to_dict(jax_hnsw.build_parameters), "cuda")

and ``hnsw_to_numpy`` gives back the same four arguments, so both packages
can be run on one identical graph.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource, make_layer
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import build_params_from_dict, params_to_dict
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
