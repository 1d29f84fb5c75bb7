"""The hop's queue update (``ops/cuda_queues``): the merge of a hop's
candidates into the queues, with the next hop's frontier, in one kernel on
the card.

On the CPU: the plain frontier of a merged queue against the top-k that
picked the frontier before (``torch.topk(-rank, b)``), the plain update
against the merge and the frontier it composes, a merge of no candidates
left as the identity on a queue that a merge made (why the kernel may skip
a row that is done), and the width limit.  On the card (marked ``cuda``):
the kernel against the plain version on the same CUDA tensors, bit for bit
(ids, the distances' bits, flags including the emptied tail's, ``changed``
and the frontier), at the hop's widths and at the limit, on queues with
ties, repeats of queued ids at equal and one-ulp-smaller distances,
``+-0.0``, ``+inf`` candidates with live ids, empty, full and done rows, and
queues that are not sorted.

This file imports no jax, so its card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_queue_merge.py
"""

import pytest
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID
from parallel_hnsw_tpu_torch.ops import cuda_queues
from parallel_hnsw_tpu_torch.ops.cuda_queues import (
    MAX_WIDTH,
    cuda_queue_update,
    plain_queue_update,
)
from parallel_hnsw_tpu_torch.ops.queues import empty_queue, merge_queue_with_flags, merged_frontier

# (queue slots, candidates): the build's ef 6 searches at M 24 and M0 48 with
# beam 4, ef 300 at both, chip_smoke's ef 1200, and the kernel's limit
CARD_WIDTHS = [(6, 96), (6, 192), (300, 96), (300, 192), (1200, 192), (MAX_WIDTH - 192, 192)]


def _topk_frontier(ids, flags, b):
    """The frontier as the hop picked it before it was carried: the ``b``
    smallest ranks, with non-frontier slots ranked ``cap``."""
    cap = ids.shape[-1]
    open_slot = (flags == 0) & (ids != EMPTY_ID)
    rank = torch.where(open_slot, torch.arange(cap, device=ids.device), cap)
    neg_rank, slots = torch.topk(-rank, b, dim=-1)
    return slots, neg_rank > -cap


def _queues(q, cap, c, b, seed, device="cpu", nan=False):
    """A hop's inputs: ``(ids, dists, flags, cand_ids, cand_dists, done,
    frontier, frontier_ok)``.  The queues are the merges of random entries
    into empty queues (sorted and deduplicated, as a layer search holds
    them): every fifth row empty, every fifth full, the rest partly so.
    Distances are multiples of 1/8, so keys tie; flags are 0 or 1 on every
    slot, the empty tail's too.  Candidates mix queued ids at their queued
    distance and one ulp below it, new ids, ``-0.0`` and ``+0.0``, ``+inf``
    with live ids and empty slots; every seventh row is done."""
    g = torch.Generator().manual_seed(seed)
    span = 3 * cap + c
    draw = 2 * cap
    new_ids = torch.randint(0, span, (q, draw), generator=g, dtype=torch.int32)
    new_d = torch.randint(0, 16, (q, draw), generator=g).float() / 8
    new_d = torch.where(torch.rand(q, draw, generator=g) < 0.05, -0.0, new_d)
    full = torch.arange(q) % 5 == 1
    # a full row draws distinct ids, at least cap of them
    new_ids[full] = torch.stack([torch.randperm(span, generator=g)[:draw] for _ in range(int(full.sum()))]).int()
    live = torch.rand(q, draw, generator=g) < torch.where(full, 1.0, 0.4)[:, None]
    live &= (torch.arange(q) % 5 != 0)[:, None]
    new_ids = torch.where(live, new_ids, EMPTY_ID)
    new_d = torch.where(live, new_d, EMPTY_DIST)
    ids, dists, _ = merge_queue_with_flags(*empty_queue(cap, (q,)), torch.zeros(q, cap, dtype=torch.int32),
                                           new_ids, new_d)[:3]
    flags = torch.randint(0, 2, (q, cap), generator=g, dtype=torch.int32)

    cand_ids = torch.randint(0, span, (q, c), generator=g, dtype=torch.int32)
    cand_d = torch.randint(0, 16, (q, c), generator=g).float() / 8
    kind = torch.randint(0, 8, (q, c), generator=g)
    pick = torch.randint(0, cap, (q, c), generator=g)
    queued_ids, queued_d = torch.gather(ids, 1, pick), torch.gather(dists, 1, pick)
    queued = queued_ids != EMPTY_ID
    cand_ids = torch.where((kind <= 1) & queued, queued_ids, cand_ids)
    cand_d = torch.where((kind == 0) & queued, queued_d, cand_d)  # a tie with the queued entry
    cand_d = torch.where((kind == 1) & queued, torch.nextafter(queued_d, torch.tensor(-1.0)), cand_d)
    cand_d = torch.where(kind == 2, -0.0, cand_d)
    cand_d = torch.where(kind == 3, 0.0, cand_d)
    cand_d = torch.where(kind == 4, float("inf"), cand_d)  # live ids at +inf
    if nan:
        cand_d = torch.where(kind == 5, float("nan"), cand_d)
    empty = kind == 6
    cand_ids = torch.where(empty, EMPTY_ID, cand_ids)
    cand_d = torch.where(empty, EMPTY_DIST, cand_d)
    done = torch.arange(q) % 7 == 3
    frontier, frontier_ok = merged_frontier(ids, flags, b)
    out = (ids, dists, flags, cand_ids, cand_d, done, frontier, frontier_ok)
    return tuple(t.to(device) for t in out)


def _same(got, want):
    """Bit for bit: distances compared as their bits."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


# -- on the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("q, cap, b, open_share", [
    (64, 8, 4, 0.5), (64, 6, 6, 0.3), (64, 30, 4, 0.1), (64, 30, 1, 0.0), (64, 300, 4, 0.02),
    (64, 12, 4, 1.0),
])
def test_merged_frontier_matches_topk(q, cap, b, open_share):
    """The valid picks are the top-k's, in the same order, and so is the
    any-unexpanded bit; the fillers are distinct slots off the frontier."""
    g = torch.Generator().manual_seed(cap * 100 + b)
    ids = torch.randint(0, 1000, (q, cap), generator=g, dtype=torch.int32)
    ids = torch.where(torch.rand(q, cap, generator=g) < 0.2, EMPTY_ID, ids)
    flags = (torch.rand(q, cap, generator=g) >= open_share).int()
    slots, ok = merged_frontier(ids, flags, b)
    want_slots, want_ok = _topk_frontier(ids, flags, b)
    assert slots.dtype == torch.int64 and ok.dtype == torch.bool and slots.is_contiguous()
    assert torch.equal(ok, want_ok)
    assert torch.equal(slots[ok], want_slots[want_ok])
    assert torch.equal(ok[:, 0], torch.any((flags == 0) & (ids != EMPTY_ID), dim=-1))
    assert all(len(set(row.tolist())) == b for row in slots)
    open_slot = (flags == 0) & (ids != EMPTY_ID)
    assert not torch.gather(open_slot, 1, slots)[~ok].any()


@pytest.mark.parametrize("cap, c, b", [(6, 24, 4), (20, 16, 4), (9, 40, 9)])
def test_plain_update_is_the_merge_and_its_frontier(cap, c, b):
    """Rows not done: the merge and the merged queue's frontier; done rows:
    their queue, flags and frontier as they were, ``changed`` clear."""
    ids, dists, flags, cand_ids, cand_d, done, frontier, ok = _queues(70, cap, c, b, seed=cap)
    got = plain_queue_update(ids, dists, flags, cand_ids, cand_d, done, frontier, ok)
    m = merge_queue_with_flags(ids, dists, flags, cand_ids, cand_d)
    live = ~done
    for g, w in zip(got[:3], m[:3]):
        assert torch.equal(g[live].view(torch.int32), w[live].view(torch.int32))
    assert torch.equal(got[3], m[3] & live)
    f, f_ok = merged_frontier(m[0], m[2], b)
    assert torch.equal(got[4][live], f[live]) and torch.equal(got[5][live], f_ok[live])
    _same([t[done] for t in got[:3] + got[4:]], [t[done] for t in (ids, dists, flags, frontier, ok)])
    assert not got[3][done].any()
    # without done, every row merges
    _same(plain_queue_update(ids, dists, flags, cand_ids, cand_d, None, frontier, ok)[:4], m)


@pytest.mark.parametrize("cap, c", [(6, 96), (30, 16), (300, 192)])
def test_a_merge_of_no_candidates_leaves_a_merged_queue_as_it_is(cap, c):
    """A done row gets only empty candidates: merged into a queue that a
    merge made, they change nothing, so the kernel skips such rows."""
    ids, dists, flags, cand_ids, cand_d, _, _, _ = _queues(40, cap, c, 4, seed=7)
    ids, dists, flags, _ = merge_queue_with_flags(ids, dists, flags, cand_ids, cand_d)
    none_ids = torch.full_like(cand_ids, EMPTY_ID)
    none_d = torch.full_like(cand_d, EMPTY_DIST)
    again = merge_queue_with_flags(ids, dists, flags, none_ids, none_d)
    _same(again[:3], (ids, dists, flags))
    assert not again[3].any()


def test_widths_above_the_limit_raise():
    ids, dists, flags, cand_ids, cand_d, done, frontier, ok = _queues(
        2, MAX_WIDTH - 95, 96, 4, seed=1)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        cuda_queue_update(ids, dists, flags, cand_ids, cand_d, done, frontier, ok)
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda_queue_update(*_queues(2, 8, 12, 4, seed=1))


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _kernel_against_plain(args):
    want = plain_queue_update(*args)
    work = tuple(t.clone() if t is not None else None for t in args)
    before = cuda_queues.LAUNCHES["queue_merge"]
    got = cuda_queue_update(*work)
    torch.cuda.synchronize()
    assert cuda_queues.LAUNCHES["queue_merge"] == before + 1
    # in place: the queue, flags and frontier are the tensors passed in
    for i in (0, 1, 2, 4, 5):
        assert got[i] is work[i if i < 3 else i + 2]
    _same(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cap, c", CARD_WIDTHS)
def test_kernel_equals_the_plain_version(device, cap, c):
    b = min(4, cap)
    args = _queues(512, cap, c, b, seed=cap + c, device=device)
    got = _kernel_against_plain(args)
    ids, dists, flags, cand_ids, cand_d, done, _, _ = args
    # the merge itself, row by row, as merge_queue_with_flags gives it
    m = merge_queue_with_flags(ids, dists, flags, cand_ids, cand_d)
    live = ~done
    for g, w in zip(got[:3], m[:3]):
        assert torch.equal(g[live].view(torch.int32), w[live].view(torch.int32))
    assert torch.equal(got[3], m[3] & live)
    # the frontier: the top-k's valid picks, and distinct fillers off it
    slots, ok = _topk_frontier(got[0], got[2], b)
    assert torch.equal(got[5][live], ok[live])
    assert torch.equal(got[4][live][got[5][live]], slots[live][ok[live]])
    assert (torch.sort(got[4], dim=1).values.diff(dim=1) > 0).all()
    # the cases the inputs were drawn to hold are there
    assert bool((got[1].view(torch.int32) == torch.tensor(-0.0).view(torch.int32).item()).any())
    assert bool((ids == EMPTY_ID).all(dim=1).any()) and bool((ids != EMPTY_ID).all(dim=1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("cap, c", [(6, 192), (300, 192)])
def test_kernel_sorts_a_queue_that_is_not_sorted(device, cap, c):
    args = list(_queues(256, cap, c, 4, seed=3, device=device))
    g = torch.Generator(device="cpu").manual_seed(5)
    perm = torch.stack([torch.randperm(cap, generator=g) for _ in range(256)]).to(device)
    for i in (0, 1, 2):
        args[i] = torch.gather(args[i], 1, perm)
    _kernel_against_plain(tuple(args))


@pytest.mark.cuda
def test_kernel_orders_nan_after_inf(device):
    _kernel_against_plain(_queues(256, 300, 192, 4, seed=11, device=device, nan=True))


@pytest.mark.cuda
def test_kernel_at_the_hop_shape_and_every_row_done(device):
    """8,192 rows at ef 300 (the batch cell's block); then every row done:
    nothing moves and nothing changed."""
    args = _queues(8192, 300, 192, 4, seed=13, device=device)
    _kernel_against_plain(args)
    done = torch.ones(8192, dtype=torch.bool, device=device)
    args = args[:5] + (done,) + args[6:]
    _kernel_against_plain(args)


@pytest.mark.cuda
def test_kernel_raises_above_its_limit(device):
    args = _queues(4, MAX_WIDTH - 191, 192, 4, seed=2, device=device)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        cuda_queue_update(*args)
