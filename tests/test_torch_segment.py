"""The port's segmented row rebuild and symmetrization, exactly equal to the
JAX package on random edge lists with ties, duplicates, self-edges and EMPTY
padding — including the chunked fold past MAX_SORT_ELEMENTS."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.ops import segment as jseg
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.ops import segment as tseg

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)


def _edges(seed, n=50, e=4000):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    dist = (rng.integers(0, 40, size=e) / 8).astype(np.float32)  # many ties
    # duplicate (dst, src) pairs with slightly different distances
    dst[e // 2 :] = dst[: e // 2]
    src[e // 2 :] = src[: e // 2]
    dist[e // 2 :] = dist[: e // 2] + rng.uniform(0, 1e-3, size=e // 2).astype(np.float32)
    dst[rng.random(e) < 0.05] = EMPTY_ID
    src[rng.random(e) < 0.05] = EMPTY_ID
    dist[rng.random(e) < 0.02] = np.inf
    return n, dst, src, dist


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_rebuild_rows_equals_jax(seed):
    n, dst, src, dist = _edges(seed)
    want = jseg.rebuild_rows(n, 4, jnp.asarray(dst), jnp.asarray(src), jnp.asarray(dist))
    got = tseg.rebuild_rows(n, 4, *map(torch.from_numpy, (dst, src, dist)))
    _assert_same(got, want)


def test_chunked_fold_equals_jax_and_flat(monkeypatch):
    n, dst, src, dist = _edges(7)
    flat = tseg._rebuild_rows_flat(n, 4, *map(torch.from_numpy, (dst, src, dist)))
    monkeypatch.setattr(tseg, "MAX_SORT_ELEMENTS", 512)
    monkeypatch.setattr(jseg, "MAX_SORT_ELEMENTS", 512)
    want = jseg.rebuild_rows(n, 4, jnp.asarray(dst), jnp.asarray(src), jnp.asarray(dist))
    got = tseg.rebuild_rows(n, 4, *map(torch.from_numpy, (dst, src, dist)))
    _assert_same(got, want)
    _assert_same(got, flat)


def test_merge_slabs_equals_jax():
    rng = np.random.default_rng(5)
    slabs = []
    for _ in range(2):
        ids = rng.integers(0, 30, size=(40, 6)).astype(np.int32)
        d = (rng.integers(0, 10, size=(40, 6)) / 4).astype(np.float32)
        ids[:, 4:] = EMPTY_ID
        d[:, 4:] = np.inf
        slabs += [ids, d]
    want = jseg._merge_slabs(*map(jnp.asarray, slabs), 6)
    got = tseg._merge_slabs(*map(torch.from_numpy, slabs), 6)
    _assert_same(got, want)


def test_symmetrize_equals_jax():
    rng = np.random.default_rng(9)
    n, m = 60, 5
    nb = rng.integers(0, n, size=(n, m)).astype(np.int32)
    d = (rng.integers(0, 20, size=(n, m)) / 16).astype(np.float32)
    nb[:, -1] = EMPTY_ID
    d[:, -1] = np.inf
    want = jseg.symmetrize(jnp.asarray(nb), jnp.asarray(d))
    got = tseg.symmetrize(torch.from_numpy(nb), torch.from_numpy(d))
    _assert_same(got, want)
