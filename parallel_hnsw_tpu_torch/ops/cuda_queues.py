"""The beam-search hop's queue update: its kernel for Hopper, the wrapper,
the plain version and the dispatch.

One hop merges ``b * M`` new candidates into each query's queue of ``cap``
slots (:func:`~parallel_hnsw_tpu_torch.ops.queues.merge_queue_with_flags`),
and the next hop expands the first ``b`` unexpanded slots of the result
(:func:`~parallel_hnsw_tpu_torch.ops.queues.merged_frontier`).
``queue_update`` does both for a block of queries; on the card it is one
kernel (``csrc/queue_merge.cu``, which replaces no Pallas kernel: the JAX
package leaves this step to XLA's sort), in place of four radix sorts, about
ten gathers and a top-k.  See the source's header for design and bound.

The kernel updates the queue, its flags and the frontier in place; rows
whose ``done`` is set are left as they are.  :func:`plain_queue_update`
computes the same, bit for bit, into new tensors: it is what a CPU tensor
takes and what the card's tests hold the kernel to.

:func:`cuda_hop_update` is the same launch with the hop's termination
accounting at the end of each row (probes, ``done``, the improvement hop and
the flag a CUDA graph's host reads): the second of the card's two hop
launches (``search.py``), after ``cuda_gather.cuda_hop_expand``.  Its plain
version is :func:`plain_hop_update`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from parallel_hnsw_tpu_torch.ops import _native
from parallel_hnsw_tpu_torch.ops.queues import merge_queue_with_flags, merged_frontier

#: kernel launches, counted where the wrapper launches; a launch captured
#: into a CUDA graph counts at each replay, not at capture (``hop_graph``)
LAUNCHES = {"queue_merge": 0}
#: the widest row (queue slots + candidates) the kernel's shared memory holds
MAX_WIDTH = 4096

Update = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok) -> None:
    q, cap = ids.shape
    if ids.dtype != torch.int32 or flags.dtype != torch.int32 or dists.dtype != torch.float32:
        raise TypeError(f"need int32 ids and flags and float32 dists, got {ids.dtype}, "
                        f"{flags.dtype}, {dists.dtype}")
    if cand_ids.dtype != torch.int32 or cand_dists.dtype != torch.float32:
        raise TypeError(f"need int32 candidate ids and float32 candidate dists, got "
                        f"{cand_ids.dtype}, {cand_dists.dtype}")
    if frontier.dtype != torch.int64 or frontier_ok.dtype != torch.bool:
        raise TypeError(f"need an int64 frontier and a bool frontier_ok, got {frontier.dtype}, "
                        f"{frontier_ok.dtype}")
    if dists.shape != (q, cap) or flags.shape != (q, cap):
        raise ValueError(f"queue shapes differ: {tuple(ids.shape)}, {tuple(dists.shape)}, "
                         f"{tuple(flags.shape)}")
    if cand_ids.dim() != 2 or cand_ids.shape[0] != q or cand_dists.shape != cand_ids.shape:
        raise ValueError(f"need candidates [{q}, c], got {tuple(cand_ids.shape)} and "
                         f"{tuple(cand_dists.shape)}")
    b = frontier.shape[-1]
    if frontier.shape != (q, b) or frontier_ok.shape != (q, b) or not 0 < b <= cap:
        raise ValueError(f"need a frontier [{q}, b] with 0 < b <= {cap}, got "
                         f"{tuple(frontier.shape)} and {tuple(frontier_ok.shape)}")
    if done is not None and (done.dtype != torch.bool or done.shape != (q,)):
        raise ValueError(f"need done [{q}] bool, got {done.dtype} {tuple(done.shape)}")
    tensors = [ids, dists, flags, cand_ids, cand_dists, frontier, frontier_ok]
    if done is not None:
        tensors.append(done)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several devices: {sorted({str(t.device) for t in tensors})}")


def plain_queue_update(
    ids: torch.Tensor,
    dists: torch.Tensor,
    flags: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    done: Optional[torch.Tensor],
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
) -> Update:
    """Plain PyTorch version of :func:`cuda_queue_update`, into new tensors:
    ``(ids, dists, flags, changed, frontier, frontier_ok)``, the merge of
    the candidates into the queues (``merge_queue_with_flags``, new entries
    with flag 0) and the merged queues' frontier of ``frontier.shape[-1]``
    slots (``merged_frontier``); rows whose ``done`` is set keep their queue,
    flags and frontier, and their ``changed`` is clear."""
    _check(ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok)
    m_ids, m_dists, m_flags, changed = merge_queue_with_flags(ids, dists, flags, cand_ids, cand_dists)
    m_front, m_ok = merged_frontier(m_ids, m_flags, frontier.shape[-1])
    if done is None:
        return m_ids, m_dists, m_flags, changed, m_front, m_ok
    keep = done[:, None]
    return (torch.where(keep, ids, m_ids), torch.where(keep, dists, m_dists),
            torch.where(keep, flags, m_flags), changed & ~done,
            torch.where(keep, frontier, m_front), torch.where(keep, frontier_ok, m_ok))


def _launch(name: str, ids, dists, flags, cand_ids, cand_dists, done, changed, frontier,
            frontier_ok, accounting=()) -> None:
    """One launch of the queue-merge kernel for ``name``'s wrapper, after
    the checks every launch needs; ``accounting`` is ``(probes,
    improve_hop, hop, all_done)`` or empty."""
    q, cap = ids.shape
    c, b = cand_ids.shape[1], frontier.shape[1]
    if cap + c > MAX_WIDTH:
        raise ValueError(f"a queue of {cap} slots and {c} candidates is {cap + c} entries a row, "
                         f"over the queue-merge kernel's MAX_WIDTH of {MAX_WIDTH}")
    if c == 0:
        raise ValueError("no candidates to merge")
    if ids.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {ids.device}")
    probes, improve_hop, hop, all_done = accounting or (None, None, 0, None)
    in_place = [ids, dists, flags, frontier, frontier_ok]
    if accounting:
        in_place += [probes, improve_hop, done]
    if not all(t.is_contiguous() for t in in_place):
        raise ValueError(f"{name} updates contiguous tensors in place")
    if q == 0:
        return
    cand_ids, cand_dists = cand_ids.contiguous(), cand_dists.contiguous()
    done = done.contiguous() if done is not None else None
    counter = hop if isinstance(hop, torch.Tensor) else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _native.load()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.queue_merge(
            ids.data_ptr(), dists.data_ptr(), flags.data_ptr(), cand_ids.data_ptr(),
            cand_dists.data_ptr(), ptr(done), ptr(changed), frontier.data_ptr(),
            frontier_ok.data_ptr(), ptr(probes), ptr(improve_hop), ptr(counter),
            0 if counter is not None else int(hop), ptr(all_done), q, cap, c, b, stream,
        )
    if err != 0:
        raise RuntimeError(f"queue_merge kernel launch failed: CUDA error {err}")
    LAUNCHES["queue_merge"] += 1


def cuda_queue_update(
    ids: torch.Tensor,
    dists: torch.Tensor,
    flags: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    done: Optional[torch.Tensor],
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
) -> Update:
    """``ids, flags [Q, cap] int32``, ``dists [Q, cap] f32``, ``cand_ids
    [Q, c] int32``, ``cand_dists [Q, c] f32``, ``done [Q] bool`` or
    ``None``, ``frontier [Q, b] int64``, ``frontier_ok [Q, b] bool`` -> what
    :func:`plain_queue_update` returns, by the CUDA kernel: ``ids``,
    ``dists``, ``flags``, ``frontier`` and ``frontier_ok`` are updated in
    place and returned, ``changed [Q] bool`` is new.  The in-place tensors
    must be contiguous; ``cap + c`` is at most :data:`MAX_WIDTH`."""
    _check(ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok)
    changed = torch.empty((ids.shape[0],), dtype=torch.bool, device=ids.device)
    _launch("cuda_queue_update", ids, dists, flags, cand_ids, cand_dists, done, changed, frontier,
            frontier_ok)
    return ids, dists, flags, changed, frontier, frontier_ok


HopUpdate = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor]


def _check_accounting(done, probes, improve_hop, hop) -> None:
    q = done.shape[0]
    for name, t in (("probes", probes), ("improve_hop", improve_hop)):
        if t.dtype != torch.int32 or t.shape != (q,) or t.device != done.device:
            raise ValueError(f"need {name} [{q}] int32 on {done.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if isinstance(hop, torch.Tensor) and (hop.dtype != torch.int32 or hop.shape != ()
                                          or hop.device != done.device):
        raise ValueError(f"need a hop counter: an int32 scalar on {done.device}, got {hop.dtype} "
                         f"{tuple(hop.shape)} on {hop.device}")


def plain_hop_update(
    ids: torch.Tensor,
    dists: torch.Tensor,
    flags: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    done: torch.Tensor,
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
    probes: torch.Tensor,
    improve_hop: torch.Tensor,
    hop,
) -> HopUpdate:
    """Plain PyTorch version of :func:`cuda_hop_update`, into new tensors:
    ``(ids, dists, flags, frontier, frontier_ok, probes, done, improve_hop)``.
    The queue update of :func:`plain_queue_update`, then for each row that
    was not done: ``probes`` less 1 where the merge left the queue as it was;
    ``done`` where ``probes`` reached 0 or the new queue has no frontier
    slot; ``improve_hop`` = ``hop`` (this hop's number, counted from 1: an
    integer or an int32 scalar tensor) where the head's id changed."""
    _check_accounting(done, probes, improve_hop, hop)
    m_ids, m_dists, m_flags, changed, m_front, m_ok = plain_queue_update(
        ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok)
    going = ~done
    m_probes = torch.where(going & ~changed, probes - 1, probes)
    finished = going & ((m_probes <= 0) | ~m_ok[:, 0])
    improved = going & (m_ids[:, 0] != ids[:, 0])
    m_improve = torch.where(improved, torch.as_tensor(hop, dtype=torch.int32, device=ids.device),
                            improve_hop)
    return m_ids, m_dists, m_flags, m_front, m_ok, m_probes, done | finished, m_improve


def cuda_hop_update(
    ids: torch.Tensor,
    dists: torch.Tensor,
    flags: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    done: torch.Tensor,
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
    probes: torch.Tensor,
    improve_hop: torch.Tensor,
    hop,
    all_done: Optional[torch.Tensor] = None,
) -> HopUpdate:
    """What :func:`plain_hop_update` returns, by one launch of the
    queue-merge kernel (counted in ``LAUNCHES["queue_merge"]``), every
    returned tensor updated in place.  ``hop`` is this hop's number, a host
    integer or an int32 scalar on the device (a CUDA graph's hop counter,
    read when the kernel runs).  ``all_done``, a bool scalar on the device,
    is cleared where a row is still going after the hop: set before the
    launch (``cuda_gather.cuda_hop_expand`` sets it), it then reads whether
    every row is done."""
    _check(ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok)
    _check_accounting(done, probes, improve_hop, hop)
    if all_done is not None and (all_done.dtype != torch.bool or all_done.shape != ()):
        raise ValueError(f"need all_done: a bool scalar, got {all_done.dtype} {tuple(all_done.shape)}")
    _launch("cuda_hop_update", ids, dists, flags, cand_ids, cand_dists, done, None, frontier,
            frontier_ok, (probes, improve_hop, hop, all_done))
    return ids, dists, flags, frontier, frontier_ok, probes, done, improve_hop


def queue_update(
    ids: torch.Tensor,
    dists: torch.Tensor,
    flags: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    done: Optional[torch.Tensor],
    frontier: torch.Tensor,
    frontier_ok: torch.Tensor,
) -> Update:
    """Dispatch on the queue's device: the kernel, in place, for a CUDA
    tensor; the plain version for a CPU tensor; anything else raises."""
    args = (ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok)
    if ids.device.type == "cuda":
        return cuda_queue_update(*args)
    if ids.device.type == "cpu":
        return plain_queue_update(*args)
    raise ValueError(f"no queue-update path for device {ids.device}")
