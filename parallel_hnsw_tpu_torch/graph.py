"""Graph data model: dense tensors instead of pointer-chasing
(counterpart of ``parallel_hnsw_tpu.graph``, dense part).

Per layer

* ``nodes  [N]    int32`` — sorted vector ids (ascending)
* ``neighbors [N, M] int32`` — node-id rows, ``EMPTY_ID``-padded

plus a *vector source* that gathers feature vectors for ids.  Every tensor of
an index lives on the source's device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_ID, ID_DTYPE


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


Source = DenseSource


def source_get(source: Source, ids: torch.Tensor) -> torch.Tensor:
    """Gather feature vectors for ``ids`` (any shape) -> ``[*ids.shape, D]``.

    Ids are clipped into range (a CUDA gather out of range is a device-side
    assert); EMPTY_ID gathers a real row, so callers mask distances of
    invalid slots to +inf."""
    safe = torch.clamp(ids, 0, source.vectors.shape[0] - 1)
    return source.vectors[safe]


def source_effective_width(source: Source) -> int:
    """Bytes-per-vector proxy for block-size budgeting; the JAX package pads
    the width to 128 lanes, kept here so block sizes agree."""
    return max(source.dim, 128)


def materialize_source(source: Source) -> torch.Tensor:
    """The source as a dense f32 ``[N, D]`` tensor (no copy for DenseSource)."""
    return source.vectors


def gather_features(source: Source, ids: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """source_get in row blocks for 1-D id tensors."""
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
