"""The row-gather kernels for Hopper, their wrappers, plain versions and
dispatches.

Counterparts of ``scripts/gather_kernel_study.py::dma_gather`` (the Pallas
``_gather_kernel``: one DMA per row from scalar-prefetched indices), launched
through ctypes:

* ``row_gather`` (``csrc/row_gather.cu``) copies rows as bytes, so one kernel
  serves every gather of whole rows: f32 feature rows, bf16 routing rows,
  int32 neighbor rows and ``[M, width]`` hop-slab rows.
* ``gather_distance`` (``csrc/gather_distance.cu``) is that gather redesigned
  for its main site, the beam-search hop: it gathers the candidate rows of
  each query into shared memory and writes only their distances to the
  query, so the ``[Q, K, D]`` block of rows never reaches device memory.  Its
  summation order depends on the row width alone, so a query's distances do
  not depend on the batch it sits in.
* ``hop_expand`` (``csrc/gather_distance.cu`` too) is the hop's first launch
  on the card: from the queue's frontier it marks the expanded slots, reads
  the expanded nodes' neighbor rows, maps them to vectors (or indexes a hop
  slab by the node) and computes the candidates' distances by
  ``gather_distance``'s own loop, in place of the torch operations around it
  (``search.py``); ``cuda_queues.cuda_hop_update`` is its second.  Its plain
  version is :func:`plain_hop_expand`.

See each source's header for design and bound.  ``row_gather``'s indices
must be in range on entry, as in the Pallas kernel: the kernel does not check
them, and the callers clamp (``graph.source_get``, the hop).  An index of
``gather_distance`` outside the table (the hop's ``EMPTY_ID``) brings no row
and gives ``+inf`` distances.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID
from parallel_hnsw_tpu_torch.ops import _native
# the metric codes are the same in every csrc/*.cu
from parallel_hnsw_tpu_torch.ops.cuda_distance import _MAX_INT, _METRIC_CODE
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance

#: kernel launches, counted where a wrapper launches; a launch captured into
#: a CUDA graph counts at each replay, not at capture (``hop_graph``)
LAUNCHES = {"row_gather": 0, "gather_distance": 0, "hop_expand": 0}


def _check_table(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() < 2:
        raise ValueError(f"need a table of rows [N, ...], got shape {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"row indices must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table on {table.device}, indices on {idx.device}")


def plain_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cuda_row_gather`:
    ``out[*i, ...] = table[idx[*i], ...]``."""
    _check_table(table, idx)
    out = table.index_select(0, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *table.shape[1:])


def cuda_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [N, ...]``, ``idx [*S] int32`` -> ``[*S, ...]`` of the table's
    type, by the CUDA kernel: ``out[*i, ...] = table[idx[*i], ...]``.

    The table must be contiguous (its rows are copied as bytes); ``idx`` may
    be any view and is made contiguous here.  Every index must lie in
    ``[0, N)``: the kernel does not check."""
    _check_table(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"cuda_row_gather needs CUDA tensors, got {table.device}")
    if not table.is_contiguous():
        raise ValueError("cuda_row_gather needs a contiguous table")
    n = table.shape[0]
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    out = torch.empty((*idx.shape, *table.shape[1:]), dtype=table.dtype, device=table.device)
    rows = idx.numel()
    if rows == 0 or row_bytes == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather rows from an empty table")
    idx = idx.contiguous()
    lib = _native.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.row_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n, row_bytes, stream
        )
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error {err}")
    LAUNCHES["row_gather"] += 1
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch on the table's device: the kernel for a CUDA tensor, the plain
    version for a CPU tensor; anything else raises."""
    if table.device.type == "cuda":
        return cuda_row_gather(table, idx)
    if table.device.type == "cpu":
        return plain_row_gather(table, idx)
    raise ValueError(f"no row-gather path for device {table.device}")


def _check_gather_distance(queries: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> None:
    if queries.dim() != 2 or queries.dtype != torch.float32:
        raise TypeError(f"need float32 queries [Q, D], got {queries.dtype} {tuple(queries.shape)}")
    if table.dim() not in (2, 3) or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"need a float32 or bfloat16 table [N, D] or [N, sub, D], got {table.dtype} "
            f"{tuple(table.shape)}"
        )
    if table.shape[-1] != queries.shape[1]:
        raise ValueError(f"rows of {table.shape[-1]} values against queries of {queries.shape[1]}")
    if idx.dtype != torch.int32:
        raise TypeError(f"row indices must be int32, got {idx.dtype}")
    if idx.dim() != 2 or idx.shape[0] != queries.shape[0]:
        raise ValueError(f"need indices [Q, K] for {queries.shape[0]} queries, got {tuple(idx.shape)}")
    if not (queries.device == table.device == idx.device):
        raise ValueError(f"queries on {queries.device}, table on {table.device}, indices on {idx.device}")


def plain_gather_distance(
    queries: torch.Tensor, table: torch.Tensor, idx: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """Plain PyTorch version of :func:`cuda_gather_distance`: the hop as two
    steps, :func:`plain_row_gather` of the candidate rows, then
    :func:`~parallel_hnsw_tpu_torch.ops.distance.batched_distance`, with
    ``+inf`` where the index lies outside the table."""
    _check_gather_distance(queries, table, idx)
    q, d = queries.shape
    inside = (idx >= 0) & (idx < table.shape[0])
    cands = plain_row_gather(table, torch.where(inside, idx, 0)).reshape(q, -1, d)
    dist = batched_distance(queries, cands, metric)
    sub = 1 if table.dim() == 2 else table.shape[1]
    return torch.where(inside.repeat_interleave(sub, dim=1), dist, float("inf"))


def cuda_gather_distance(
    queries: torch.Tensor, table: torch.Tensor, idx: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """``queries [Q, D]`` f32, ``table [N, D]`` or ``[N, sub, D]`` (f32 or bf16),
    ``idx [Q, K] int32`` -> ``d [Q, K * sub]`` f32 by the CUDA kernel, with
    ``d[q, k * sub + j]`` the ``metric`` distance of query ``q`` to row ``j``
    of ``table[idx[q, k]]`` (bf16 rows widened, every product and sum f32),
    and ``+inf`` where ``idx[q, k]`` lies outside ``[0, N)`` (nothing is read
    for it).  The table must be contiguous."""
    metric = Metric(metric)
    _check_gather_distance(queries, table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"cuda_gather_distance needs CUDA tensors, got {table.device}")
    if not table.is_contiguous():
        raise ValueError("cuda_gather_distance needs a contiguous table")
    q, d = queries.shape
    k = idx.shape[1]
    sub = 1 if table.dim() == 2 else table.shape[1]
    if max(q, table.shape[0], k * sub, d) > _MAX_INT:
        raise ValueError(f"Q={q}, N={table.shape[0]}, K x sub={k * sub}, D={d} out of the kernel's range")
    out = torch.empty((q, k * sub), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    queries, idx = queries.contiguous(), idx.contiguous()
    lib = _native.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gather_distance(
            queries.data_ptr(), table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            q, table.shape[0], k, sub, d, table.element_size(), _METRIC_CODE[metric], stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_distance kernel launch failed: CUDA error {err}")
    LAUNCHES["gather_distance"] += 1
    return out


def gather_distance(
    queries: torch.Tensor, table: torch.Tensor, idx: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """Dispatch on the table's device: the kernel for a CUDA tensor, the plain
    version for a CPU tensor; anything else raises."""
    if table.device.type == "cuda":
        return cuda_gather_distance(queries, table, idx, metric)
    if table.device.type == "cpu":
        return plain_gather_distance(queries, table, idx, metric)
    raise ValueError(f"no gather-distance path for device {table.device}")


Expand = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_hop(queries, table, nodes, neighbors, ids, expanded, frontier, frontier_ok, done,
               evals) -> None:
    q, cap = ids.shape
    n_layer, m = neighbors.shape
    if table.dim() == 2:
        if nodes is None or nodes.shape != (n_layer,) or nodes.dtype != torch.int32:
            raise ValueError(f"a source's rows need the layer's nodes [{n_layer}] int32")
    elif table.dim() != 3 or nodes is not None or tuple(table.shape[:2]) != (n_layer, m):
        raise ValueError(f"need source rows [V, D] with the layer's nodes, or a hop slab "
                         f"[{n_layer}, {m}, D] without; got {tuple(table.shape)}")
    if queries.dim() != 2 or queries.dtype != torch.float32 or queries.shape[0] != q:
        raise TypeError(f"need float32 queries [{q}, D], got {queries.dtype} {tuple(queries.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16) or table.shape[-1] != queries.shape[1]:
        raise TypeError(f"need float32 or bfloat16 rows of {queries.shape[1]} values, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if neighbors.dtype != torch.int32 or ids.dtype != torch.int32 or expanded.dtype != torch.int32:
        raise TypeError(f"need int32 neighbors, ids and expanded flags, got {neighbors.dtype}, "
                        f"{ids.dtype}, {expanded.dtype}")
    b = frontier.shape[-1]
    if (expanded.shape != (q, cap) or frontier.shape != (q, b) or frontier_ok.shape != (q, b)
            or not 0 < b <= cap or done.shape != (q,)):
        raise ValueError(f"need ids, expanded [{q}, {cap}], a frontier [{q}, b] with 0 < b <= "
                         f"{cap} and done [{q}]; got {tuple(expanded.shape)}, "
                         f"{tuple(frontier.shape)}, {tuple(frontier_ok.shape)}, {tuple(done.shape)}")
    if (frontier.dtype != torch.int64 or frontier_ok.dtype != torch.bool
            or done.dtype != torch.bool or evals.dtype != torch.int64 or evals.shape != ()):
        raise TypeError("need an int64 frontier, bool frontier_ok and done, and an int64 scalar evals")
    tensors = [queries, table, neighbors, ids, expanded, frontier, frontier_ok, done, evals]
    if len({t.device for t in tensors + ([nodes] if nodes is not None else [])}) != 1:
        raise ValueError("the hop's tensors are on several devices")


def plain_hop_expand(
    queries: torch.Tensor,
    table: torch.Tensor,
    nodes: Optional[torch.Tensor],
    neighbors: torch.Tensor,
    ids: torch.Tensor,
    expanded: torch.Tensor,
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
    done: torch.Tensor,
    evals: torch.Tensor,
    metric: Metric,
) -> Expand:
    """Plain PyTorch version of :func:`cuda_hop_expand`, into new tensors:
    ``(expanded, cand_ids, cand_dists, evals)``.

    A frontier slot expands where ``frontier_ok`` is set and ``done`` is
    clear: its flag becomes 1, and the neighbor row of its node (clamped
    into the layer) gives ``M`` candidates, ``cand_ids [Q, b * M]`` (node
    ids, ``EMPTY_ID`` for a slot that does not expand and for an empty
    neighbor).  ``table`` is a source's rows ``[V, D]``, read at
    ``nodes[candidate]`` (the candidate clamped into the layer), or a hop
    slab ``[N, M, D]`` (``nodes`` ``None``), read at the slot's node;
    ``cand_dists`` are their :func:`plain_gather_distance`, ``+inf`` for
    every ``EMPTY_ID`` candidate; ``evals`` gains the number of candidates."""
    metric = Metric(metric)
    _check_hop(queries, table, nodes, neighbors, ids, expanded, frontier, frontier_ok, done, evals)
    q, b = frontier.shape
    n_layer, m = neighbors.shape
    expand = frontier_ok & ~done[:, None]
    node = torch.gather(ids, 1, frontier)
    rows = plain_row_gather(neighbors, torch.clamp(node, 0, n_layer - 1))
    cand_ids = torch.where(expand[..., None], rows, EMPTY_ID).reshape(q, b * m)
    valid = cand_ids != EMPTY_ID
    if nodes is not None:
        vec = torch.where(valid, nodes[torch.clamp(cand_ids, 0, n_layer - 1).long()], EMPTY_ID)
        d = plain_gather_distance(queries, table, vec, metric)
    else:
        d = plain_gather_distance(queries, table, torch.where(expand, node, EMPTY_ID), metric)
    flags = expanded.scatter(1, frontier, torch.where(expand, 1, torch.gather(expanded, 1, frontier)))
    return flags, cand_ids, torch.where(valid, d, EMPTY_DIST), evals + valid.sum()


def cuda_hop_expand(
    queries: torch.Tensor,
    table: torch.Tensor,
    nodes: Optional[torch.Tensor],
    neighbors: torch.Tensor,
    ids: torch.Tensor,
    expanded: torch.Tensor,
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
    done: torch.Tensor,
    evals: torch.Tensor,
    metric: Metric,
    counter: Optional[torch.Tensor] = None,
    all_done: Optional[torch.Tensor] = None,
) -> Expand:
    """What :func:`plain_hop_expand` returns, by one launch of the CUDA
    kernel (counted in ``LAUNCHES["hop_expand"]``): ``expanded`` and
    ``evals`` are updated in place and returned, ``cand_ids`` and
    ``cand_dists`` are new.  The distances are
    :func:`cuda_gather_distance`'s, bit for bit.  ``counter`` (an int32
    scalar on the device: a CUDA graph's hop counter) gains 1 and
    ``all_done`` (a bool scalar) is set, for the queue merge that follows
    (``cuda_queues.cuda_hop_update``).  Every tensor the kernel reads must
    be contiguous; queries and nodes are made so here."""
    metric = Metric(metric)
    _check_hop(queries, table, nodes, neighbors, ids, expanded, frontier, frontier_ok, done, evals)
    if table.device.type != "cuda":
        raise ValueError(f"cuda_hop_expand needs CUDA tensors, got {table.device}")
    read = (table, neighbors, ids, expanded, frontier, frontier_ok, done)
    if not all(t.is_contiguous() for t in read):
        raise ValueError("cuda_hop_expand needs a contiguous table, neighbors and hop state")
    for name, t, dtype in (("counter", counter, torch.int32), ("all_done", all_done, torch.bool)):
        if t is not None and (t.dtype != dtype or t.shape != () or t.device != table.device):
            raise ValueError(f"need {name}: a {dtype} scalar on {table.device}")
    q, d = queries.shape
    cap, b = ids.shape[1], frontier.shape[1]
    n_layer, m = neighbors.shape
    n = table.shape[0]
    if max(q, n, n_layer, b * m, d) > _MAX_INT:
        raise ValueError(f"Q={q}, N={n}, b x M={b * m}, D={d} out of the kernel's range")
    cand_ids = torch.empty((q, b * m), dtype=torch.int32, device=table.device)
    cand_dists = torch.empty((q, b * m), dtype=torch.float32, device=table.device)
    if q == 0 or m == 0:
        return expanded, cand_ids, cand_dists, evals
    queries = queries.contiguous()
    nodes = nodes.contiguous() if nodes is not None else None
    lib = _native.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hop_expand(
            queries.data_ptr(), table.data_ptr(), nodes.data_ptr() if nodes is not None else None,
            neighbors.data_ptr(), ids.data_ptr(), expanded.data_ptr(), frontier.data_ptr(),
            frontier_ok.data_ptr(), done.data_ptr(), cand_ids.data_ptr(), cand_dists.data_ptr(),
            evals.data_ptr(), counter.data_ptr() if counter is not None else None,
            all_done.data_ptr() if all_done is not None else None, q, n, d,
            table.element_size(), _METRIC_CODE[metric], cap, b, m, n_layer, stream,
        )
    if err != 0:
        raise RuntimeError(f"hop_expand kernel launch failed: CUDA error {err}")
    LAUNCHES["hop_expand"] += 1
    return expanded, cand_ids, cand_dists, evals
