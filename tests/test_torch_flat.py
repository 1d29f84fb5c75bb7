"""The port's flat scan (``fast_flat_knn``, ``search_exact(fast=True)``)
against the JAX package on the same numpy arrays (mirrors the flat-scan cases
of tests/test_distance.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import analysis as ja
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource
from parallel_hnsw_tpu_torch import BuildParams, DenseSource, Hnsw, Metric
from parallel_hnsw_tpu_torch import analysis as ta

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _recall(got, gt):
    return np.mean([len(np.intersect1d(got[i], gt[i])) for i in range(len(gt))]) / gt.shape[1]


@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN], ids=lambda m: m.value)
def test_fast_flat_knn_matches_exact_scan(metric):
    """Scan + oversampled exact rerank reproduces the exact scan's top-k
    (ids, and distances within 1e-5: both are f32 sums of 32 products), in
    the port as in the JAX package."""
    vecs, qs = _unit(500, 32, 1), _unit(37, 32, 2)
    src, queries = DenseSource(torch.from_numpy(vecs)), torch.from_numpy(qs)
    gt_ids, gt_d = ta.brute_force_knn(src, queries, metric, 10)
    ids, d = ta.fast_flat_knn(src, queries, metric, 10, oversample=4, query_block=16,
                              corpus_block=128)
    assert ids.shape == (37, 10) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), gt_ids.numpy())
    np.testing.assert_allclose(d.numpy(), gt_d.numpy(), atol=1e-5)
    j_ids, j_d = ja.fast_flat_knn(JDenseSource(jnp.asarray(vecs)), jnp.asarray(qs), metric.value,
                                  10, oversample=4, query_block=16, corpus_block=128)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(d.numpy(), np.asarray(j_d), atol=1e-5)


def test_fast_flat_knn_merges_corpus_blocks():
    """4500 rows are two exhaustive blocks (4096 + 404): the streamed merge
    keeps the exact top-k, ids offset by the block start."""
    src = DenseSource(torch.from_numpy(_unit(4500, 16, 3)))
    queries = torch.from_numpy(_unit(21, 16, 4))
    assert ta.flat_corpus_block(4500, "exhaustive", False, 8, 128) == 4096
    gt_ids, _ = ta.brute_force_knn(src, queries, Metric.COSINE, 10)
    ids, d = ta.fast_flat_knn(src, queries, Metric.COSINE, 10, query_block=8, corpus_block=128)
    np.testing.assert_array_equal(ids.numpy(), gt_ids.numpy())
    assert bool((d[:, 1:] >= d[:, :-1]).all())


@pytest.mark.parametrize("mode", ["exhaustive", "binned", "folded"])
def test_forced_scan_modes_match_jax_by_recall(mode):
    """Each forced mode against the JAX package's same mode.  Binning loses
    a neighbor when a closer row shares its tile and class, the same rows in
    both packages, so the recalls agree within 0.02 (survivor cuts differ:
    approx_min_k there, exact top-k here) and both pass the JAX test's 0.97."""
    vecs, qs = _unit(5000, 32, 5), _unit(64, 32, 6)
    src, queries = DenseSource(torch.from_numpy(vecs)), torch.from_numpy(qs)
    gt = ta.brute_force_knn(src, queries, Metric.EUCLIDEAN, 10)[0].numpy()
    ids, d = ta.fast_flat_knn(src, queries, Metric.EUCLIDEAN, 10, oversample=8, scan_mode=mode)
    j_ids, _ = ja.fast_flat_knn(JDenseSource(jnp.asarray(vecs)), jnp.asarray(qs), "euclidean", 10,
                                oversample=8, scan_mode=mode)
    recall, j_recall = _recall(ids.numpy(), gt), _recall(np.asarray(j_ids), gt)
    assert recall >= 0.97 and j_recall >= 0.97, (recall, j_recall)
    assert abs(recall - j_recall) <= 0.02, (recall, j_recall)
    if mode == "exhaustive":
        assert recall == 1.0
    assert np.all(np.diff(d.numpy(), axis=1) >= -1e-6)
    assert bool(torch.isfinite(d).all())


def test_fast_flat_knn_rejects_unknown_mode():
    src = DenseSource(torch.from_numpy(_unit(10, 4, 7)))
    with pytest.raises(ValueError, match="scan_mode"):
        ta.fast_flat_knn(src, src.vectors, Metric.DOT, 2, scan_mode="approximate")


@pytest.mark.parametrize("n", [10_000, 199_999, 200_000, 1_048_576, 1_999_999, 2_000_000,
                               2_097_152, 8_388_608])
def test_select_scan_mode_matches_jax(n):
    assert ta.select_scan_mode(n) == ja.select_scan_mode(n)
    want = "folded" if n >= 2_000_000 else "binned" if n >= 200_000 else "exhaustive"
    assert ta.select_scan_mode(n) == want


def test_flat_corpus_block_is_a_function_of_shapes():
    """The chunk rule.  CUDA operands go through the fused kernels, which
    write only the reduced bin matrix, so a binned block is tile_c/128 = 32x
    wider: 1M x 128 at query_block 4096 is one block.  The plain versions
    materialize [query_block, rows], so the CPU keeps the unreduced bound."""
    m = 1 << 20
    assert ta.flat_corpus_block(m, "binned", fused=True) == m
    assert ta.flat_corpus_block(m, "binned", fused=False) == 32768
    assert ta.flat_corpus_block(4 * m, "binned", fused=True) == m
    assert ta.flat_corpus_block(m, "binned", fused=True, query_block=8192) == m // 2
    assert ta.flat_corpus_block(m, "exhaustive", fused=True) == 32768
    assert ta.flat_corpus_block(m, "exhaustive", fused=False) == 32768
    assert ta.flat_corpus_block(m, "exhaustive", fused=True, query_block=256) == 1 << 19
    assert ta.flat_corpus_block(500, "exhaustive", False, 16, 128) == 4096
    assert ta.flat_corpus_block(500, "binned", False, 16, 128) == 4096
    assert ta.flat_corpus_block(2 * m, "folded", fused=True) == 2 * m
    assert ta.flat_corpus_block(2 * m, "folded", fused=False) == 2 * m


def test_hnsw_search_exact_fast_path():
    vecs = _unit(300, 16, 8)
    idx = Hnsw([], DenseSource(torch.from_numpy(vecs)), Metric.COSINE, BuildParams())
    queries = torch.from_numpy(vecs[:8])
    ids_exact, d_exact = idx.search_exact(queries, k=5)
    ids_fast, d_fast = idx.search_exact(queries, k=5, fast=True)
    np.testing.assert_array_equal(ids_fast.numpy(), ids_exact.numpy())
    np.testing.assert_allclose(d_fast.numpy(), d_exact.numpy(), atol=1e-5)
    ids_os, _ = idx.search_exact(queries, k=5, query_block=4, fast=True, oversample=2)
    np.testing.assert_array_equal(ids_os.numpy(), ids_exact.numpy())
