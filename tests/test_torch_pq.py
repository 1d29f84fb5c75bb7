"""The port's PQ building blocks against the JAX package on the same numpy
inputs (mirrors the module-level cases of tests/test_pq.py): reconstruction,
the dedup hash and random centroids given JAX's own draws, k-means, the three
quantize routes, and the ADC tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import graph as jgraph
from parallel_hnsw_tpu import pq as jpq
from parallel_hnsw_tpu.analysis import blocked_topk_pairwise as j_blocked_topk
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource
from parallel_hnsw_tpu.index import Hnsw as JHnsw
from parallel_hnsw_tpu.params import PqBuildParams as JPqBuildParams
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    PqBuildParams,
    PqSource,
    SearchParams,
)
from parallel_hnsw_tpu_torch import graph as tgraph
from parallel_hnsw_tpu_torch import pq as tpq
from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise
from parallel_hnsw_tpu_torch.ops.distance import pairwise_distance

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
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# reconstruction


@pytest.mark.parametrize("kind", ["shared", "per_subspace"])
@pytest.mark.parametrize("code_dtype", ["uint16", "int32"])
def test_reconstruct_matches_jax_bit_for_bit(kind, code_dtype):
    """Codes including 0 and K - 1, as uint16 and int32, through
    ``reconstruct`` and ``source_get`` of a PqSource (clipped ids)."""
    rng = np.random.default_rng(0)
    k, nsub, dsub = 300, 6, 4
    shape = (k, dsub) if kind == "shared" else (nsub, k, dsub)
    book = rng.normal(size=shape).astype(np.float32)
    codes = rng.integers(0, k, (50, nsub)).astype(code_dtype)
    codes[0], codes[1, :3] = k - 1, 0
    want = np.asarray(jgraph.reconstruct(jnp.asarray(book), jnp.asarray(codes)))
    t_codes = _t(codes) if code_dtype == "int32" else _t(codes.view(np.int16)).view(torch.uint16)
    got = tgraph.reconstruct(_t(book), t_codes)
    np.testing.assert_array_equal(got.numpy(), want)
    ids = np.array([3, 0, 49, 49, 60, -4], np.int32)  # repeats and ids out of range
    j_src = jgraph.PqSource(codes=jnp.asarray(codes), codebook=jnp.asarray(book))
    t_src = PqSource(codes=t_codes, codebook=_t(book))
    np.testing.assert_array_equal(
        tgraph.source_get(t_src, _t(ids)).numpy(),
        np.asarray(jgraph.source_get(j_src, jnp.asarray(ids))))
    assert t_src.dim == j_src.dim == nsub * dsub and t_src.count == 50
    assert tgraph.source_effective_width(t_src) == jgraph.source_effective_width(j_src)


def test_codes_narrow_and_widen_over_the_whole_uint16_range():
    codes = torch.tensor([[0, 1, 32767], [32768, 40000, 65535]], dtype=torch.int32)
    narrow = tgraph.narrow_codes(codes)
    assert narrow.dtype == torch.uint16
    assert torch.equal(tgraph.widen_codes(narrow), codes)
    assert torch.equal(tgraph.widen_codes(codes), codes)


def test_materialize_source_densifies_in_blocks():
    rng = np.random.default_rng(1)
    book = _t(rng.normal(size=(16, 2)).astype(np.float32))
    codes = _t(rng.integers(0, 16, (1000, 3)).astype(np.int32))
    src = PqSource(codes=codes, codebook=book)
    dense = tgraph.materialize_source(src, block=128)
    assert torch.equal(dense, tgraph.reconstruct(book, codes))
    assert tgraph.materialize_source(DenseSource(dense)) is dense


# ---------------------------------------------------------------------------
# dedup and centroids


def _jax_projection(seed, dim):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), (dim,),
                                                        jnp.float32)))


def test_unique_rows_device_matches_jax_given_its_projection():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(200, 4)).astype(np.float32)
    dup = np.concatenate([base, base[:77], base[13:14]])  # many exact dups
    rng.shuffle(dup)
    want = jpq.unique_rows_device(jnp.asarray(dup), seed=1)
    got = tpq.unique_rows_device(_t(dup), projection=_jax_projection(1, 4))
    np.testing.assert_array_equal(got, want)
    # and the set is np.unique's, with the port's own default draw too
    own = tpq.unique_rows_device(_t(dup), seed=1)
    np.testing.assert_array_equal(own[np.lexsort(own.T[::-1])], np.unique(dup, axis=0))


@pytest.mark.parametrize("host", [False, True], ids=["tensor", "numpy"])
def test_random_centroids_match_jax_given_its_draws(host):
    """The numpy sample matches bit for bit; with JAX's projection and
    shuffle keys injected, so do the centroids and their order."""
    vecs = _unit(50, 16, 0)
    vecs[7] = vecs[3]  # duplicate sub-vectors
    seed, k, dsub = 2, 40, 4
    want = jpq.random_centroids(vecs if host else jnp.asarray(vecs), k, dsub, seed=seed)
    key = jax.random.PRNGKey(seed)
    n_sub = min(k, 50) * 16 // dsub
    shuffle = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 1), (n_sub,))))
    got = tpq.random_centroids(vecs if host else _t(vecs), k, dsub, seed=seed,
                               projection=_jax_projection(seed, dsub), shuffle=shuffle,
                               device="cpu")
    assert got.dtype == torch.float32 and got.shape == (k, dsub)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_centroids_dedup_shape():
    cents = tpq.random_centroids(_t(_unit(50, 16, 42)), 32, 4, seed=0)
    assert cents.shape[1] == 4 and cents.shape[0] <= 32
    assert len(np.unique(cents.numpy(), axis=0)) == len(cents)


@pytest.mark.parametrize("sample", [None, 300])
def test_kmeans_sampling_matches_jax(sample):
    """With no iteration k-means returns its initial centroids: the numpy
    sample and init draws, bit for bit."""
    vecs = _unit(200, 16, 5)
    want = jpq.kmeans_centroids(vecs, 64, 4, iters=0, seed=3, sample=sample)
    got = tpq.kmeans_centroids(vecs, 64, 4, iters=0, seed=3, sample=sample, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _separated(n_per, centers, dsub, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dsub)).astype(np.float32) * 10.0
    x = c[np.repeat(np.arange(centers), n_per)] + 0.1 * rng.normal(size=(centers * n_per, dsub))
    return x.astype(np.float32)


def test_kmeans_matches_jax_after_five_iterations():
    x = _separated(40, 16, 4, 6)  # 640 sub-vectors around 16 far-apart centers
    want = jpq.kmeans_centroids(x, 16, 4, iters=5, seed=1)
    got = tpq.kmeans_centroids(x, 16, 4, iters=5, seed=1, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assign = lambda c: np.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(assign(got), assign(want))


def test_kmeans_reduces_distortion():
    vecs = _t(_unit(200, 16, 42))
    subs = vecs.reshape(-1, 4)
    rand = tpq.random_centroids(vecs, 16, 4, seed=0)
    km = tpq.kmeans_centroids(vecs, 16, 4, iters=8, seed=0)

    def distortion(cents):
        return float(pairwise_distance(subs, cents, Metric.SQUARED_EUCLIDEAN).min(1).values.mean())

    assert distortion(km) <= distortion(rand) * 1.05


def test_kmeans_big_matches_plain_path():
    """The blocked binned-argmin + index_add_ k-means (the K=65,535 path)
    converges as the plain loop does from the same init."""
    rng = np.random.default_rng(3)
    subs = _t(rng.normal(size=(4000, 4)).astype(np.float32))
    init = subs[_t(rng.permutation(4000)[:64])]
    a = tpq._kmeans_plain(subs, init, 64, 4)
    b = tpq._kmeans_big(subs, init, 64, 4, block=1024)

    def distortion(cents):
        return float(pairwise_distance(subs, cents, Metric.SQUARED_EUCLIDEAN).min(1).values.mean())

    np.testing.assert_allclose(distortion(b), distortion(a), rtol=0.02)


def test_per_subspace_centroids_shape():
    books = tpq.per_subspace_centroids(_shifted_corpus(), 32, 4, seed=0, device="cpu")
    assert books.shape == (4, 32, 4) and books.dtype == torch.float32


def test_per_subspace_centroids_match_jax():
    """Per-subspace k-means draws its initial centroids from each column
    (seed + j) as JAX does, bit for bit; few unique rows tile up to K."""
    x = _shifted_corpus()
    want = jpq.per_subspace_centroids(x, 16, 4, seed=0, iters=0)
    got = tpq.per_subspace_centroids(x, 16, 4, seed=0, iters=0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    few = np.repeat(x[:3], 5, axis=0)  # 3 unique rows, K = 8
    tiled = tpq.per_subspace_centroids(few, 8, 4, use_kmeans=False, device="cpu")
    assert tiled.shape == (4, 8, 4)
    assert all(len(np.unique(b, axis=0)) == 3 for b in tiled.numpy())


# ---------------------------------------------------------------------------
# quantizers


def _shifted_corpus(n=400, dim=16, dsub=4, seed=7):
    """Subspaces with different offsets: a per-subspace codebook has a real
    capacity advantage over a shared one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    for j in range(dim // dsub):
        x[:, j * dsub : (j + 1) * dsub] += 3.0 * j
    return x


@pytest.mark.parametrize("metric", [Metric.EUCLIDEAN, Metric.COSINE], ids=lambda m: m.value)
def test_exact_quantize_matches_jax(metric):
    """Exact quantization on the same centroids gives JAX's codes; so does
    the per-subspace quantizer's exact route."""
    vecs = _unit(200, 16, 8)
    cents = _unit(96, 4, 9)
    j_q = jpq.HnswQuantizer(JHnsw([], JDenseSource(jnp.asarray(cents)), metric.value), 4,
                            JPqBuildParams())
    t_q = tpq.HnswQuantizer(Hnsw([], DenseSource(_t(cents)), metric), 4, PQP)
    want = np.asarray(j_q.quantize(jnp.asarray(vecs), exact=True))
    got = t_q.quantize(_t(vecs), exact=True)
    assert got.dtype == torch.int32 and got.shape == (200, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    books = np.stack([_unit(64, 4, 10 + j) for j in range(4)])
    want = np.asarray(jpq.SubspaceQuantizer(jnp.asarray(books), metric.value, JPqBuildParams())
                      .quantize(jnp.asarray(vecs)))
    got = tpq.SubspaceQuantizer(_t(books), metric, PQP).quantize(_t(vecs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_binned_matches_exact():
    """The binned route against the exact argmin, in the port and in JAX."""
    rng = np.random.default_rng(9)
    subs = rng.normal(size=(3000, 4)).astype(np.float32)
    cents = rng.normal(size=(1500, 4)).astype(np.float32)
    fast = tpq.quantize_binned(_t(subs), _t(cents), Metric.SQUARED_EUCLIDEAN, block=1024)
    exact = blocked_topk_pairwise(_t(subs), _t(cents), Metric.SQUARED_EUCLIDEAN, 1)[0][:, 0]
    agree = float((fast == exact).float().mean())
    j_fast = np.asarray(jpq.quantize_binned(jnp.asarray(subs), jnp.asarray(cents),
                                            Metric.SQUARED_EUCLIDEAN, block=1024))
    j_exact = np.asarray(j_blocked_topk(jnp.asarray(subs), jnp.asarray(cents),
                                        Metric.SQUARED_EUCLIDEAN, 1)[0][:, 0])
    np.testing.assert_array_equal(exact.numpy(), j_exact)
    assert agree >= 0.999, agree  # double-collision misses only
    assert agree >= float((j_fast == j_exact).mean()) - 1e-3


def test_quantize_binned_chunk_boundaries():
    """Blocked dispatch (block < n) returns the same codes as one block."""
    rng = np.random.default_rng(12)
    subs = _t(rng.normal(size=(1000, 4)).astype(np.float32))
    cents = _t(rng.normal(size=(300, 4)).astype(np.float32))
    one = tpq.quantize_binned(subs, cents, Metric.SQUARED_EUCLIDEAN, block=4096)
    many = tpq.quantize_binned(subs, cents, Metric.SQUARED_EUCLIDEAN, block=256)
    assert torch.equal(one, many)


def test_quantizer_fast_path_end_to_end():
    """HnswQuantizer.quantize(fast=True) codes agree with exact; the graph
    route on a centroid graph nearly so."""
    vecs = _t(_unit(300, 16, 2))
    cents = tpq.random_centroids(vecs, 128, 4, seed=0)
    chnsw = Hnsw.generate(DenseSource(vectors=cents), None, SMALL_BP, Metric.SQUARED_EUCLIDEAN,
                          seed=0)
    quant = tpq.HnswQuantizer(chnsw, 4, PQP)
    c_exact = quant.quantize(vecs, exact=True)
    assert float((c_exact == quant.quantize(vecs, fast=True)).float().mean()) >= 0.99
    assert float((c_exact == quant.quantize(vecs)).float().mean()) >= 0.95


def test_subspace_quantizer_beats_shared_codebook():
    """Equal K, identical code bytes: per-subspace codebooks reconstruct
    strictly better when subspace distributions differ."""
    x = _shifted_corpus()
    k, dsub = 16, 4
    shared = tpq.kmeans_centroids(x, k, dsub, iters=8, seed=0, device="cpu")
    chnsw = Hnsw.generate(DenseSource(vectors=shared), None, SMALL_BP, Metric.SQUARED_EUCLIDEAN,
                          seed=0)
    q_shared = tpq.HnswQuantizer(chnsw, 4, PQP)
    books = tpq.per_subspace_centroids(x, k, dsub, seed=0, iters=8, device="cpu")
    q_sub = tpq.SubspaceQuantizer(books, Metric.EUCLIDEAN, PQP)

    def mse(q):
        return float(((q.reconstruct(q.quantize(_t(x), exact=True)) - _t(x)) ** 2).mean())

    assert mse(q_sub) < mse(q_shared) * 0.5, (mse(q_sub), mse(q_shared))


def test_subspace_quantizer_fast_matches_exact():
    """At K = 4096 the binned route runs per subspace; near-ties may take
    other codes, but the reconstruction quality matches."""
    x = np.random.default_rng(8).normal(size=(6000, 16)).astype(np.float32)
    books = tpq.per_subspace_centroids(x, 4096, 4, seed=1, use_kmeans=False, device="cpu")
    assert all(len(np.unique(b, axis=0)) == 4096 for b in books.numpy())
    q = tpq.SubspaceQuantizer(books, Metric.EUCLIDEAN, PQP)
    xt = _t(x)
    e_exact = ((q.reconstruct(q.quantize(xt, exact=True)) - xt) ** 2).sum(-1).mean()
    e_fast = ((q.reconstruct(q.quantize(xt, fast=True)) - xt) ** 2).sum(-1).mean()
    assert float(e_fast) <= float(e_exact) * 1.02, (float(e_fast), float(e_exact))


# ---------------------------------------------------------------------------
# ADC


@pytest.mark.parametrize("kind", ["shared", "per_subspace"])
@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_adc_matches_jax(metric, kind):
    """``adc_lut``, ``adc_scan`` and ``adc_finish`` for every metric and
    both codebook kinds, within 1e-5 of JAX's; the scan equals the distances
    to the reconstructed codes within 1e-4."""
    rng = np.random.default_rng(13)
    k, nsub, dsub = 48, 4, 4
    book = (_unit(k, dsub, 14) if kind == "shared"
            else np.stack([_unit(k, dsub, 15 + j) for j in range(nsub)]))
    queries = _unit(9, nsub * dsub, 16)
    codes = rng.integers(0, k, (70, nsub)).astype(np.uint16)
    j_lut = jpq.adc_lut(jnp.asarray(queries), jnp.asarray(book), metric.value)
    t_lut = tpq.adc_lut(_t(queries), _t(book), metric)
    assert t_lut.shape == (9, nsub, k)
    np.testing.assert_allclose(t_lut.numpy(), np.asarray(j_lut), atol=1e-5)
    t_codes = _t(codes.view(np.int16)).view(torch.uint16)
    got = tpq.adc_scan(t_lut, t_codes, metric)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpq.adc_scan(j_lut, jnp.asarray(codes), metric.value)), atol=1e-5)
    sums = t_lut.sum(1)
    np.testing.assert_allclose(tpq.adc_finish(sums, metric).numpy(),
                               np.asarray(jpq.adc_finish(jnp.asarray(sums.numpy()), metric.value)),
                               atol=1e-5)
    recon = tgraph.reconstruct(_t(book), t_codes)
    np.testing.assert_allclose(got.numpy(), pairwise_distance(_t(queries), recon, metric).numpy(),
                               atol=1e-4)
