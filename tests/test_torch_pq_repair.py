"""The port's ``QuantizedHnsw`` on an index it built itself: the index
cases of tests/test_pq.py that need no JAX twin, and the three places where a
PqSource must not be taken for dense rows (the compute phases, the hop, and
the folded flat scan's corpus blocks, held to the JAX package's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import analysis as janalysis
from parallel_hnsw_tpu.graph import PqSource as JPqSource
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    PqBuildParams,
    PqSource,
    QuantizedHnsw,
    SearchParams,
)
from parallel_hnsw_tpu_torch import analysis as tanalysis
from parallel_hnsw_tpu_torch import graph as tgraph
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.pq import adc_lut, adc_scan

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

SMALL_BP = BuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                       optimization=OptimizationParams(recall_proportion=1.0))
PQP = PqBuildParams(centroids=SMALL_BP, hnsw=SMALL_BP,
                    quantized_search=SearchParams(number_of_candidates=32,
                                                  upper_layer_candidate_count=32))


def _unit(n, d, seed):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def built():
    """The JAX tests' ``small_pq`` shape (300 x 16, 64 shared centroids,
    dsub 4, exact quantization), built by the port."""
    x = _unit(300, 16, 11)
    q = QuantizedHnsw.new(64, DenseSource(_t(x)), 4, Metric.EUCLIDEAN, pqp=PQP, seed=4,
                          exact_quantize=True)
    return q, x


def _assert_same_up_to_ties(t_ids, t_d, j_ids, j_d, atol=1e-5):
    """Distances within ``atol``; ids equal as sets at equal distance."""
    t_ids, t_d, j_ids, j_d = (np.asarray(a) for a in (t_ids, t_d, j_ids, j_d))
    np.testing.assert_allclose(t_d, j_d, atol=atol)
    for r in range(t_ids.shape[0]):
        if not np.array_equal(t_ids[r], j_ids[r]):
            inside = j_d[r] < j_d[r, -1] - atol
            assert set(t_ids[r][inside]) == set(j_ids[r][inside]), r


# ---------------------------------------------------------------------------
# the JAX tests' index cases


def test_quantize_reconstruct_roundtrip(built):
    tq, x = built
    vecs = _t(x[:20])
    recon = tq.quantizer.reconstruct(tq.quantizer.quantize(vecs, exact=True))
    assert float(torch.linalg.vector_norm(recon - vecs, dim=-1).mean()) < 1.0


def test_pq_source_distance_uses_reconstruction(built):
    tq, _ = built
    pq_src = tq.hnsw.source
    got = tgraph.source_get(pq_src, torch.tensor([0, 1], dtype=torch.int32))
    assert torch.equal(got, tq.quantizer.reconstruct(pq_src.codes[:2]))


def test_adc_flat_scan_matches_reconstruction_ranking(built):
    """Without rerank the flat scan equals brute force over the decoded
    corpus; ADC scores those distances too."""
    tq, x = built
    queries = _t(x[:20])
    ids, dists = tq.search_exact(queries, k=5, rerank=False)
    gt_ids, gt_d = tanalysis.brute_force_knn(tq.hnsw.source, queries, Metric.EUCLIDEAN, 5)
    np.testing.assert_allclose(dists.numpy(), gt_d.numpy(), atol=1e-4)
    lut = adc_lut(queries, tq.hnsw.source.codebook, Metric.EUCLIDEAN)
    scores = adc_scan(lut, tq.hnsw.source.codes, Metric.EUCLIDEAN)
    np.testing.assert_allclose(torch.gather(scores, 1, ids.long()).numpy(), dists.numpy(),
                               atol=1e-4)


def test_flat_scan_oversampled_rerank_matches_manual(built):
    """scan at oversample*k, exact-rerank, cut to k equals the manual
    pipeline (scan(rerank=False, k=oversample*k) -> exact rerank -> top-k)."""
    tq, x = built
    queries = _t(x[:16])
    k, oversample = 5, 4
    ids, dists = tq.search_exact(queries, k=k, rerank=True, oversample=oversample)
    wide_ids, _ = tq.search_exact(queries, k=k * oversample, rerank=False)
    cand = tq.full_source.vectors[wide_ids.long()]
    d_exact = torch.linalg.vector_norm(cand - queries[:, None, :], dim=-1).numpy()
    order = np.argsort(d_exact, axis=-1, kind="stable")[:, :k]
    want_d = np.take_along_axis(d_exact, order, -1)
    np.testing.assert_allclose(dists.numpy(), want_d, atol=1e-5)
    want_ids = np.take_along_axis(wide_ids.numpy(), order, -1)
    mism = ids.numpy() != want_ids
    assert np.all(np.isclose(dists.numpy()[mism], want_d[mism], atol=1e-5))


def test_flat_scan_rerank_recall_matches_exact_scan(built):
    tq, x = built
    queries = _t(x[:32])
    gt_ids, _ = tanalysis.brute_force_knn(tq.full_source, queries, Metric.EUCLIDEAN, 5)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) for a, b in zip(ids.tolist(), gt_ids.tolist())]) / 5

    r_fast = recall(tq.search_exact(queries, k=5, rerank=True)[0])
    r_exact = recall(tq.search_exact(queries, k=5, rerank=True, oversample=1)[0])
    assert r_fast >= r_exact - 1e-9


# ---------------------------------------------------------------------------
# a PqSource is not dense rows


def test_no_compute_phase_reconstructs_under_the_budget(built):
    """Under ``DENSIFY_BUDGET_BYTES`` the code graph's compute phases run on
    the densified copy: once it exists, ``source_get`` never sees the
    PqSource (a build sees it only to densify, in whole row blocks)."""
    tq, x = built
    pq_src = tq.hnsw.source
    impl = tgraph.source_get.dispatch(PqSource)
    calls = []

    def spy(source, ids):
        calls.append(ids.clone())
        return impl(source, ids)

    tgraph.source_get.register(PqSource, spy)
    try:
        built = Hnsw.generate(pq_src, None, tq.hnsw.build_parameters, Metric.EUCLIDEAN, seed=1)
        # the build touched the codes once: to densify them
        assert torch.equal(torch.cat(calls), torch.arange(pq_src.count, dtype=torch.int32))
        calls.clear()
        queries = _t(x[:30])
        built.search(queries)
        built.search_ids(np.arange(10))
        built.search_exact(queries, k=5)
        built.search_exact(queries, k=5, fast=True)
        built.stochastic_recall()
        built.improve_neighbors()
        built.improve_index()
        built.promote_at_layer(0)
        built.discover_unreachable_vectors(built.layer_count - 1)
        built.knn(3)
        built.enable_routing(dr=None)
        built.enable_hop_slabs()
        built.search(queries)
        assert calls == [], f"{len(calls)} source_get calls reached the PqSource"
    finally:
        tgraph.source_get.register(PqSource, impl)


def test_non_dense_route_gives_the_densified_answers(built):
    """With ``DENSIFY_BUDGET_BYTES = 0`` on the instance the hop
    reconstructs + ``batched_distance`` (EMPTY_ID -> +inf): search and both
    ``search_exact`` modes give the densified index's ids and distances."""
    tq, x = built
    dense = tq.hnsw
    sparse = Hnsw(dense.layers, dense.source, dense.metric, dense.build_parameters)
    sparse.DENSIFY_BUDGET_BYTES = 0
    assert isinstance(sparse.compute_source, PqSource)
    assert isinstance(dense.compute_source, DenseSource)
    queries = tq.quantizer.reconstruct(tq.quantizer.quantize(_t(x[:64]), exact=True))
    for call in (lambda h: h.search(queries), lambda h: h.search_exact(queries, k=10),
                 lambda h: h.search_exact(queries, k=10, fast=True)):
        (a_i, a_d), (b_i, b_d) = call(sparse), call(dense)
        assert torch.equal(a_i, b_i)
        np.testing.assert_allclose(a_d.numpy(), b_d.numpy(), atol=1e-5)
    q_sparse = QuantizedHnsw(tq.quantizer, sparse, tq.full_source)
    assert torch.equal(q_sparse.search(_t(x[:64]))[0], tq.search(_t(x[:64]))[0])
    ids = torch.tensor([[0, 5, EMPTY_ID], [299, EMPTY_ID, 1]], dtype=torch.int32)
    d = tgraph.source_distance(dense.source, queries[:2], ids, Metric.EUCLIDEAN)
    want = tgraph.source_distance(dense.compute_source, queries[:2], ids, Metric.EUCLIDEAN)
    assert torch.equal(torch.isinf(d), ids == EMPTY_ID)
    assert torch.equal(d, want)


def test_folded_flat_scan_blocks_a_pq_source_as_jax(built, monkeypatch):
    """The folded scan takes a dense corpus as one block but reconstructs a
    PqSource in budgeted blocks: the port's blocks are JAX's, and so are the
    answers."""
    tq, _ = built
    rng = np.random.default_rng(5)
    book = tq.hnsw.source.codebook
    codes = rng.integers(0, book.shape[0], (10_000, 4)).astype(np.uint16)
    queries = _unit(40, 16, 6)
    t_src = PqSource(codes=_t(codes.view(np.int16)).view(torch.uint16), codebook=book)
    j_src = JPqSource(codes=jnp.asarray(codes), codebook=jnp.asarray(book.numpy()))
    j_blocks, t_blocks = [], []
    j_get, t_get = janalysis.source_get, tanalysis.gather_features
    monkeypatch.setattr(janalysis, "source_get", lambda s, ids: (
        j_blocks.append(int(ids.shape[0])) if ids.ndim == 1 else None) or j_get(s, ids))
    monkeypatch.setattr(tanalysis, "gather_features", lambda s, ids: (
        t_blocks.append(int(ids.shape[0]))) or t_get(s, ids))
    kw = dict(oversample=4, query_block=64, corpus_block=64, scan_mode="folded")
    j_ids, j_d = janalysis.fast_flat_knn(j_src, jnp.asarray(queries), "euclidean", 10, **kw)
    t_ids, t_d = tanalysis.fast_flat_knn(t_src, _t(queries), Metric.EUCLIDEAN, 10, **kw)
    assert t_blocks == j_blocks == [4096, 4096, 1808]
    assert tanalysis.flat_corpus_block(10_000, "folded", False, 64, 64, dense=False) == 4096
    assert tanalysis.flat_corpus_block(10_000, "folded", False, 64, 64) == 10_000
    _assert_same_up_to_ties(t_ids, t_d, j_ids, j_d)
