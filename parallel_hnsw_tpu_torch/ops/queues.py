"""Masked sorted-array candidate queues (counterpart of ``parallel_hnsw_tpu.ops.queues``).

A queue is ``(ids, dists)`` sorted ascending by ``(dist, id)`` with
``(EMPTY_ID, +inf)`` padding.  Batched insertion is: concatenate,
lexicographic sort, adjacent dedup, truncate; "did anything change" is an
any-change reduction.  All ops work on the last axis and broadcast over
leading batch dims.

``torch.sort`` takes one key, so multi-key sorts are stable passes from the
least significant key to the most (:func:`lexsort_perm`).  Float keys compare
as IEEE values (``-0.0 == 0.0``, ``+inf`` last), as ``lax.sort`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from parallel_hnsw_tpu_torch.constants import DIST_DTYPE, EMPTY_DIST, EMPTY_ID, ID_DTYPE


def lexsort_perm(*keys: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Permutation (int64) that sorts stably by ``keys[0]``, ties broken by
    ``keys[1]``, and so on; all keys share one shape."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, dim, perm)
        order = torch.sort(k, dim=dim, stable=True).indices
        perm = order if perm is None else torch.gather(perm, dim, order)
    return perm


def empty_queue(
    capacity: int, batch_shape: Tuple[int, ...] = (), device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A queue of ``capacity`` empty slots (reference: PriorityQueue::new)."""
    shape = tuple(batch_shape) + (capacity,)
    ids = torch.full(shape, EMPTY_ID, dtype=ID_DTYPE, device=device)
    dists = torch.full(shape, EMPTY_DIST, dtype=DIST_DTYPE, device=device)
    return ids, dists


def sort_queue(ids: torch.Tensor, dists: torch.Tensor, *payload: torch.Tensor):
    """Sort ascending by ``(dist, id)``; payload tensors are permuted along."""
    perm = lexsort_perm(dists, ids)
    out = [torch.gather(t, -1, perm) for t in (ids, dists) + payload]
    return tuple(out)


def _mark_adjacent_dups(ids: torch.Tensor, dists: torch.Tensor, *payload: torch.Tensor):
    """Empty out later duplicates of an id among adjacent equal entries."""
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[..., 1:] = (ids[..., 1:] == ids[..., :-1]) & (ids[..., 1:] != EMPTY_ID)
    ids = torch.where(dup, EMPTY_ID, ids)
    dists = torch.where(dup, EMPTY_DIST, dists)
    return (ids, dists) + tuple(payload)


def dedup_sorted(ids: torch.Tensor, dists: torch.Tensor, *payload: torch.Tensor):
    """Dedup a (dist, id)-sorted queue, compacting empties to the tail."""
    return sort_queue(*_mark_adjacent_dups(ids, dists, *payload))


def merge_queue(
    ids: torch.Tensor,
    dists: torch.Tensor,
    new_ids: torch.Tensor,
    new_dists: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge ``(new_ids, new_dists)`` into sorted queues of fixed capacity.

    Entries that land beyond capacity fall off; returns ``changed`` — whether
    the retained contents differ (the reference's ``did_something``,
    priority_queue.rs:109-144).  Invalid new entries must be masked as
    ``(EMPTY_ID, +inf)`` by the caller.
    """
    cap = ids.shape[-1]
    s_ids, s_dists = sort_queue(
        torch.cat([ids, new_ids], dim=-1), torch.cat([dists, new_dists], dim=-1)
    )
    d_ids, d_dists = dedup_sorted(s_ids, s_dists)
    out_ids = d_ids[..., :cap]
    out_dists = d_dists[..., :cap]
    changed = torch.any(out_ids != ids, dim=-1)
    return out_ids, out_dists, changed


def merge_queue_with_flags(
    ids: torch.Tensor,
    dists: torch.Tensor,
    flags: torch.Tensor,
    new_ids: torch.Tensor,
    new_dists: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`merge_queue` but carries a per-slot payload flag (the
    "already expanded" bit of beam search).  New entries enter with flag=0.

    The stable sort keeps a pre-existing entry *before* a freshly merged
    duplicate with equal ``(dist, id)``, so dedup retains the existing flag.
    """
    cap = ids.shape[-1]
    s_ids, s_dists, s_flags = sort_queue(
        torch.cat([ids, new_ids], dim=-1),
        torch.cat([dists, new_dists], dim=-1),
        torch.cat([flags, torch.zeros_like(new_ids, dtype=flags.dtype)], dim=-1),
    )
    d_ids, d_dists, d_flags = dedup_sorted(s_ids, s_dists, s_flags)
    out_ids = d_ids[..., :cap]
    changed = torch.any(out_ids != ids, dim=-1)
    return out_ids, d_dists[..., :cap], d_flags[..., :cap], changed
