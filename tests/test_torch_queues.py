"""The port's candidate queues: the Rust golden vectors of tests/test_queues.py
(reference priority_queue.rs:225-440) and random queues with ties, duplicates
and EMPTY padding, exactly equal to the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.ops import queues as jq
from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID
from parallel_hnsw_tpu_torch.ops import queues as tq

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)

E = EMPTY_ID
INF = EMPTY_DIST

# (queue ids, queue dists, new ids, new dists, expected ids, expected dists, changed)
GOLDEN = {
    "insert_at_beginning": ([0, 3, E], [0.1, 1.2, INF], [4], [0.01], [4, 0, 3], [0.01, 0.1, 1.2], True),
    "insert_into_empty": ([E, E, E], [INF, INF, INF], [4], [0.01], [4, E, E], [0.01, INF, INF], True),
    "no_double_count": ([4, E, E], [0.01, INF, INF], [4], [0.01], [4, E, E], [0.01, INF, INF], False),
    "push_off_end": ([1, 2, 3], [0.1, 0.2, 0.4], [4], [0.3], [1, 2, 4], [0.1, 0.2, 0.3], True),
    "past_end": ([1, 2, 3], [0.1, 0.2, 0.3], [4], [0.4], [1, 2, 3], [0.1, 0.2, 0.3], False),
    "interleaved": ([0, 2, 4], [0.0, 0.2, 0.4], [1, 3, 5], [0.1, 0.3, 0.5], [0, 1, 2], [0.0, 0.1, 0.2], True),
    "useless": ([0, 3, 5], [0.0, 0.3, 0.5], [6, 7, 8], [0.6, 0.7, 0.8], [0, 3, 5], [0.0, 0.3, 0.5], False),
    "productive": ([0, 3, 5], [0.0, 0.3, 0.5], [1, 2, 4], [0.1, 0.2, 0.4], [0, 1, 2], [0.0, 0.1, 0.2], True),
    "repeated_equal_priorities": ([0, 3, 5], [0.0] * 3, [0, 4, 3], [0.0] * 3, [0, 3, 4], [0.0] * 3, True),
    "with_empty_slots": ([0, 3, E], [0.0, 1.2, INF], [0, 3, 4], [0.0] * 3, [0, 3, 4], [0.0] * 3, True),
    "lots_of_zeros": (
        [0] + [E] * 8, [0.0] + [INF] * 8,
        [3, 4, 1, 2, 6, 7], [0.29289323, 0.4227, 1.0, 1.0, 1.0, 1.0],
        [0, 3, 4, 1, 2, 6, 7, E, E], [0.0, 0.29289323, 0.4227, 1.0, 1.0, 1.0, 1.0, INF, INF], True,
    ),
}


def _t(ids, dists):
    return torch.tensor(ids, dtype=torch.int32), torch.tensor(dists, dtype=torch.float32)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_merge_golden(case):
    ids, dists, new_ids, new_dists, want_ids, want_dists, want_changed = GOLDEN[case]
    out_ids, out_dists, changed = tq.merge_queue(*_t(ids, dists), *_t(new_ids, new_dists))
    np.testing.assert_array_equal(out_ids.numpy(), want_ids)
    np.testing.assert_allclose(out_dists.numpy(), np.asarray(want_dists, np.float32))
    assert bool(changed) == want_changed


def test_batched_merge_and_flags():
    ids = torch.tensor([[0, 3, 5], [0, 2, 4]], dtype=torch.int32)
    dists = torch.tensor([[0.0, 0.3, 0.5], [0.0, 0.2, 0.4]])
    new_ids = torch.tensor([[6, 7, 8], [1, 3, 5]], dtype=torch.int32)
    new_dists = torch.tensor([[0.6, 0.7, 0.8], [0.1, 0.3, 0.5]])
    out_ids, _, changed = tq.merge_queue(ids, dists, new_ids, new_dists)
    np.testing.assert_array_equal(out_ids.numpy(), [[0, 3, 5], [0, 1, 2]])
    np.testing.assert_array_equal(changed.numpy(), [False, True])

    # re-merge id 0 (already expanded) plus a fresh id 1: the existing flag wins
    out_ids, _, out_flags, changed = tq.merge_queue_with_flags(
        *_t([0, 3, 5], [0.0, 0.3, 0.5]), torch.tensor([1, 1, 0], dtype=torch.int32),
        *_t([0, 1], [0.0, 0.1]),
    )
    np.testing.assert_array_equal(out_ids.numpy(), [0, 1, 3])
    np.testing.assert_array_equal(out_flags.numpy(), [1, 0, 1])
    assert bool(changed)


def test_sort_and_dedup_golden():
    si, sd = tq.sort_queue(*_t([5, 1, 5, E], [0.5, 0.1, 0.5, INF]))
    np.testing.assert_array_equal(si.numpy(), [1, 5, 5, E])
    di, _ = tq.dedup_sorted(si, sd)
    np.testing.assert_array_equal(di.numpy(), [1, 5, E, E])


def _random_queue(rng, shape, id_range):
    """Sorted, deduped queues with tied distances, duplicate ids and EMPTY tails."""
    ids = rng.integers(0, id_range, size=shape).astype(np.int32)
    dists = rng.integers(0, 6, size=shape).astype(np.float32) / 4  # many ties
    empty = rng.random(shape) < 0.2
    ids[empty] = EMPTY_ID
    dists[empty] = np.inf
    return ids, dists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_merges_equal_jax(seed):
    rng = np.random.default_rng(seed)
    cap, new = 12, 20
    ids, dists = _random_queue(rng, (64, cap), 30)
    ids, dists = (np.array(a) for a in jq.dedup_sorted(*jq.sort_queue(jnp.asarray(ids), jnp.asarray(dists))))
    new_ids, new_dists = _random_queue(rng, (64, new), 30)
    flags = rng.integers(0, 2, size=(64, cap)).astype(np.int32)

    want = jq.merge_queue_with_flags(*map(jnp.asarray, (ids, dists, flags, new_ids, new_dists)))
    got = tq.merge_queue_with_flags(*map(torch.from_numpy, (ids, dists, flags, new_ids, new_dists)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    want = jq.merge_queue(*map(jnp.asarray, (ids, dists, new_ids, new_dists)))
    got = tq.merge_queue(*map(torch.from_numpy, (ids, dists, new_ids, new_dists)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    raw_ids, raw_dists = _random_queue(rng, (64, new), 30)
    raw_dists[:, ::5] = -0.0  # -0.0 and 0.0 compare equal, settled by id
    want = jq.dedup_sorted(*jq.sort_queue(jnp.asarray(raw_ids), jnp.asarray(raw_dists)))
    got = tq.dedup_sorted(*tq.sort_queue(torch.from_numpy(raw_ids), torch.from_numpy(raw_dists)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empty_queue():
    ids, dists = tq.empty_queue(5, (2,))
    assert ids.shape == (2, 5) and ids.dtype == torch.int32
    assert bool((ids == EMPTY_ID).all()) and bool(torch.isinf(dists).all())
