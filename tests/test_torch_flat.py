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


# ---------------------------------------------------------------------------
# the blocked flat scan (``flat.blocked_scan``) under each of its callers


def _pq_index(n, rng):
    from parallel_hnsw_tpu_torch import QuantizedHnsw
    from parallel_hnsw_tpu_torch.graph import PqSource

    # distinct codes: no two rows tie in the scan, so its survivors are unique
    pairs = rng.choice(256 * 256, n, replace=False)
    codes = torch.from_numpy(np.stack([pairs // 256, pairs % 256], 1).astype(np.int16))
    codes = codes.view(torch.uint16)
    books = torch.from_numpy(rng.normal(size=(2, 256, 4)).astype(np.float32))
    full = DenseSource(torch.from_numpy(_unit(n, 8, 21)))
    return QuantizedHnsw(None, Hnsw([], PqSource(codes=codes, codebook=books), Metric.EUCLIDEAN,
                                    BuildParams()), full)


def _sharded_scan(blocks, monkeypatch):
    from parallel_hnsw_tpu_torch.parallel import Mesh, ShardedHnsw
    from parallel_hnsw_tpu_torch.parallel import sharded

    rows = [DenseSource(torch.from_numpy(_unit(3000, 8, 22 + s))) for s in range(2)]
    gids = np.arange(6000, dtype=np.int32).reshape(2, 3000)
    sh = ShardedHnsw.from_shard_sources(rows, gids, Mesh(["cpu"] * 2), metric=Metric.EUCLIDEAN,
                                        build_graphs=False)
    with monkeypatch.context() as m:
        if blocks > 1:  # a shard's block is a constant; cut it to 1000 rows here
            real = sharded.block_scan
            m.setattr(sharded, "block_scan", lambda n, fast: (real(n, fast)[0], 1000))
        return sh.search_exact(torch.from_numpy(_unit(30, 8, 24)), k=10, fast=True)


def _blocked_scan_case(caller, blocks, monkeypatch):
    """``caller``'s answer with its corpus cut into ``blocks`` > 1 scan blocks,
    or into one."""
    rng = np.random.default_rng(20)
    if caller.startswith("flat"):
        src, queries = DenseSource(torch.from_numpy(_unit(10_000, 16, 20))), torch.from_numpy(
            _unit(50, 16, 25))
        # on the CPU a block is at least 4096 rows: 3 blocks, or the whole corpus
        return ta.fast_flat_knn(src, queries, Metric.EUCLIDEAN, 10, query_block=16,
                                corpus_block=128 if blocks > 1 else 10_000,
                                scan_mode=caller.split("-")[1])
    if caller.startswith("topk"):
        feats = torch.from_numpy(_unit(700, 12, 20))
        return ta.blocked_topk_pairwise(feats, feats, Metric.NORMALIZED_COSINE, 9,
                                        col_block=300 if blocks > 1 else 700,
                                        exclude_diag_offset=0, fast=caller == "topk-fast")
    if caller.startswith("pq"):
        return _pq_index(5000, rng).search_exact(
            torch.from_numpy(_unit(40, 8, 26)), k=10, rerank=caller == "pq-fast",
            code_block=700 if blocks > 1 else 5000, query_block=16)
    return _sharded_scan(blocks, monkeypatch)


@pytest.mark.parametrize("caller", ["flat-exhaustive", "flat-binned", "topk-exact", "topk-fast",
                                    "pq-exact", "pq-fast", "sharded"])
def test_blocked_scan_merges_blocks_as_one(caller, monkeypatch):
    """Every caller of the shared blocked scan: a corpus cut into several
    scan blocks gives the same ids and distances as the same scan in one
    block (the merge keeps each block's survivors by ``(dist, id)``)."""
    many_i, many_d = _blocked_scan_case(caller, 3, monkeypatch)
    one_i, one_d = _blocked_scan_case(caller, 1, monkeypatch)
    assert torch.equal(many_i, one_i) and torch.equal(many_d, one_d)
    assert bool((many_d[:, 1:] >= many_d[:, :-1]).all())


@pytest.mark.parametrize("n", [199_999, 200_000, 1_999_999, 2_000_000])
def test_each_caller_keeps_its_scan_route(n, monkeypatch):
    """The kernel (mode) and corpus block each caller hands the shared scan,
    on both sides of 200,000 and 2,000,000 rows: the flat scan exhaustive,
    binned or folded; the PQ and shard scans binned on 2^19-row blocks from
    200k rows when fast and never folded; the brute-force tiers pairwise
    only.  The corpora are views of one row; nothing is scanned."""
    from parallel_hnsw_tpu_torch import analysis, pq
    from parallel_hnsw_tpu_torch.graph import PqSource
    from parallel_hnsw_tpu_torch.parallel import sharded

    seen = []

    def scan(queries, corpus, rows, metric, mode, k_scan, block, query_block, **kw):
        seen.append((mode, block))
        return torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1))

    for module in (analysis, pq, sharded):
        monkeypatch.setattr(module, "blocked_scan", scan)
    q = torch.zeros((1, 8))
    dense = DenseSource(torch.zeros((1, 8)).expand(n, 8))
    rows = torch.zeros((1, 1)).expand(n, 1)
    codes = PqSource(codes=torch.zeros((1, 2), dtype=torch.int32).expand(n, 2),
                     codebook=torch.zeros((2, 4, 4)))
    ta.fast_flat_knn(dense, q, Metric.EUCLIDEAN, 10)
    index = pq.QuantizedHnsw(None, Hnsw([], codes, Metric.EUCLIDEAN, BuildParams()), dense)
    monkeypatch.setattr(index, "_rerank", lambda queries, ids: (ids, ids.float()))
    for fast in (True, False):
        index.search_exact(q, rerank=fast)
        sharded._shard_flat_scan(codes, q, Metric.EUCLIDEAN, 40, fast)
        ta.blocked_topk_pairwise(q[:, :1], rows, Metric.EUCLIDEAN, 1, fast=fast)
    flat = "folded" if n >= 2_000_000 else "binned" if n >= 200_000 else "exhaustive"
    code = "binned" if n >= 200_000 else "exhaustive"
    code_block = 1 << 19 if n >= 200_000 else 1 << 16
    assert [mode for mode, _ in seen] == [flat, code, code, "exhaustive", "exact", "exact", "exact"]
    assert [block for _, block in seen[1:]] == [code_block, 1 << 19, 1 << 16, 1 << 16, 1 << 19,
                                                1 << 16]
