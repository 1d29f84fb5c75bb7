"""The port's ``QuantizedHnsw`` against the JAX package's (mirrors the index
cases of tests/test_pq.py).  One JAX index of each quantizer kind is built
once per module and carried across with ``convert``, so both packages search
one identical graph; the port's own build is held to JAX's recall."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import pq as jpq
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource
from parallel_hnsw_tpu.graph import Layer as JLayer
from parallel_hnsw_tpu.graph import PqSource as JPqSource
from parallel_hnsw_tpu.index import Hnsw as JHnsw
from parallel_hnsw_tpu.params import BuildParams as JBuildParams
from parallel_hnsw_tpu.params import OptimizationParams as JOptimizationParams
from parallel_hnsw_tpu.params import PqBuildParams as JPqBuildParams
from parallel_hnsw_tpu.params import SearchParams as JSearchParams
from parallel_hnsw_tpu.params import build_params_from_dict as j_bp_from_dict
from parallel_hnsw_tpu.params import pq_build_params_from_dict as j_pqp_from_dict
from parallel_hnsw_tpu_torch import (
    DenseSource,
    Metric,
    PqSource,
    QuantizedHnsw,
    SubspaceQuantizer,
)
from parallel_hnsw_tpu_torch.convert import quantized_from_numpy, quantized_to_numpy
from parallel_hnsw_tpu_torch.params import pq_build_params_from_dict

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

J_BP = JBuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                    optimization=JOptimizationParams(recall_proportion=1.0))
J_PQP = JPqBuildParams(centroids=J_BP, hnsw=J_BP,
                       quantized_search=JSearchParams(number_of_candidates=32,
                                                      upper_layer_candidate_count=32))


def _unit(n, d, seed):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_from_numpy(state):
    """A JAX QuantizedHnsw from ``quantized_to_numpy``'s dict."""
    metric = state["metric"]
    book = jnp.asarray(state["codebook"])
    layers = lambda ls: [JLayer(nodes=jnp.asarray(n), neighbors=jnp.asarray(nb)) for n, nb in ls]
    pqp = j_pqp_from_dict(state["pq_params"])
    if book.ndim == 3:
        quantizer = jpq.SubspaceQuantizer(book, metric, pqp)
    else:
        quantizer = jpq.HnswQuantizer(
            JHnsw(layers(state["centroid_layers"]), JDenseSource(book), metric,
                  j_bp_from_dict(state["centroid_build_params"])), state["nsub"], pqp)
    code_graph = JHnsw(layers(state["code_layers"]),
                       JPqSource(codes=jnp.asarray(state["codes"]), codebook=book), metric,
                       j_bp_from_dict(state["build_params"]))
    return jpq.QuantizedHnsw(quantizer, code_graph, JDenseSource(jnp.asarray(state["vectors"])))


@pytest.fixture(scope="module")
def shared():
    """The JAX package's ``small_pq`` fixture (src/pq.rs:865-919's shape:
    300 x 16, 64 shared centroids, dsub 4), built by JAX and carried across."""
    x = _unit(300, 16, 11)
    jq = jpq.QuantizedHnsw.new(64, JDenseSource(jnp.asarray(x)), 4, "euclidean", pqp=J_PQP,
                               seed=4, exact_quantize=True)
    return jq, quantized_from_numpy(quantized_to_numpy(jq), "cpu"), x


@pytest.fixture(scope="module")
def subspace():
    """The JAX package's ``subspace_pq`` fixture's shape: per-subspace
    k-means codebooks, no centroid graph."""
    x = _unit(300, 16, 21)
    jq = jpq.QuantizedHnsw.new(64, JDenseSource(jnp.asarray(x)), 4, "euclidean", pqp=J_PQP,
                               seed=4, per_subspace=True, use_kmeans=True)
    return jq, quantized_from_numpy(quantized_to_numpy(jq), "cpu"), x


@pytest.fixture(params=["shared", "subspace"])
def both(request):
    return request.getfixturevalue(request.param)


def _assert_same_up_to_ties(t_ids, t_d, j_ids, j_d, atol=1e-5):
    """Distances within ``atol``; ids equal as sets at equal distance (tie
    order may differ under another summation order)."""
    t_ids, t_d, j_ids, j_d = (np.asarray(a) for a in (t_ids, t_d, j_ids, j_d))
    np.testing.assert_allclose(t_d, j_d, atol=atol)
    for r in range(t_ids.shape[0]):
        if np.array_equal(t_ids[r], j_ids[r]):
            continue
        # rows differ only inside groups of tied distances, and not past the cut
        cut = j_d[r, -1]
        inside = j_d[r] < cut - atol
        assert set(t_ids[r][inside]) == set(j_ids[r][inside]), r


def test_convert_carries_the_index_both_ways(both):
    jq, tq, _ = both
    state = quantized_to_numpy(tq)
    j_state = quantized_to_numpy(jq)  # duck-typed: a JAX index as well
    assert state["codes"].dtype == np.uint16 and tq.hnsw.source.codes.dtype == torch.uint16
    for key in ("codes", "codebook", "vectors"):
        np.testing.assert_array_equal(state[key], j_state[key])
    for key in ("code_layers", "centroid_layers"):
        if j_state[key] is None:
            assert state[key] is None and tq.centroid_hnsw() is None
            continue
        for (a, b), (c, d) in zip(state[key], j_state[key]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    assert {k: state[k] for k in ("metric", "pq_params", "build_params", "nsub")} == {
        k: j_state[k] for k in ("metric", "pq_params", "build_params", "nsub")}
    assert pq_build_params_from_dict(state["pq_params"]) == tq.quantizer.pq_params
    back = _jax_from_numpy(state)
    q = jnp.asarray(tq.full_source.vectors[:20].numpy())
    for a, b in zip(back.search_exact(q, k=5), jq.search_exact(q, k=5)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("rerank", [True, False], ids=["rerank", "codes"])
def test_search_exact_matches_jax(both, rerank):
    jq, tq, x = both
    queries = x[:64]
    j_ids, j_d = jq.search_exact(jnp.asarray(queries), k=10, rerank=rerank)
    t_ids, t_d = tq.search_exact(_t(queries), k=10, rerank=rerank)
    assert t_ids.shape == (64, 10) and t_ids.dtype == torch.int32
    _assert_same_up_to_ties(t_ids, t_d, j_ids, j_d)


def test_search_top1_agrees_with_jax_on_the_same_graph(both):
    jq, tq, x = both
    j_ids, _ = jq.search(jnp.asarray(x), rerank=True, exact_quantize=True)
    t_ids, t_d = tq.search(_t(x), rerank=True, exact_quantize=True)
    agree = float(np.mean(t_ids[:, 0].numpy() == np.asarray(j_ids[:, 0])))
    assert agree >= 0.99, agree
    # reranked distances are exact, ascending over the finite prefix
    capped = torch.where(torch.isfinite(t_d), t_d, 1e30)
    assert bool((capped[:, 1:] - capped[:, :-1] >= -1e-6).all())


def test_code_graph_walk_matches_jax_on_integer_subvectors(shared):
    """The shared fixture's graphs over an integer codebook and integer
    queries under squared euclidean, where every f32 distance is exact in
    both packages: the quantized queries and the code-graph walks agree
    exactly (ids and distances)."""
    jq, _, x = shared
    state = quantized_to_numpy(jq)
    rng = np.random.default_rng(31)
    state["codebook"] = rng.integers(-4, 5, state["codebook"].shape).astype(np.float32)
    state["vectors"] = rng.integers(-4, 5, state["vectors"].shape).astype(np.float32)
    state["metric"] = "squared_euclidean"
    je, te = _jax_from_numpy(state), quantized_from_numpy(state, "cpu")
    queries = rng.integers(-4, 5, (48, 16)).astype(np.float32)
    j_codes = np.asarray(je.quantizer.quantize(jnp.asarray(queries), exact=True))
    np.testing.assert_array_equal(te.quantizer.quantize(_t(queries), exact=True).numpy(), j_codes)
    j_ids, j_d = je.search(jnp.asarray(queries), rerank=False, exact_quantize=True)
    t_ids, t_d = te.search(_t(queries), rerank=False, exact_quantize=True)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("per_subspace", [False, True], ids=["shared", "subspace"])
def test_port_build_reaches_jax_recall(shared, subspace, per_subspace):
    """``QuantizedHnsw.new`` in the port (its own draws) against the JAX
    build on the same corpus: recall@1 after rerank >= 0.9 (the JAX test's
    bar) and within 0.02 of JAX's."""
    jq, tq, x = subspace if per_subspace else shared
    kw = {"per_subspace": True, "use_kmeans": True} if per_subspace else {"exact_quantize": True}
    q = QuantizedHnsw.new(64, DenseSource(_t(x)), 4, Metric.EUCLIDEAN,
                          pqp=tq.quantizer.pq_params, seed=4, **kw)
    assert isinstance(q.hnsw.source, PqSource) and q.hnsw.source.codes.dtype == torch.uint16
    ids, _ = q.search(_t(x), rerank=True, exact_quantize=True)
    j_ids, _ = jq.search(jnp.asarray(x), rerank=True, exact_quantize=True)
    recall = float(np.mean(ids[:, 0].numpy() == np.arange(300)))
    j_recall = float(np.mean(np.asarray(j_ids[:, 0]) == np.arange(300)))
    assert recall >= 0.9 and abs(recall - j_recall) <= 0.02, (recall, j_recall)


def test_per_subspace_end_to_end_search(subspace):
    _, tq, x = subspace
    assert isinstance(tq.quantizer, SubspaceQuantizer) and tq.centroid_hnsw() is None
    ids, _ = tq.search(_t(x), rerank=True)
    assert float(np.mean(ids[:, 0].numpy() == np.arange(300))) >= 0.9
    ids, _ = tq.search_exact(_t(x[:64]), k=10, rerank=True)
    assert float(np.mean(ids[:, 0].numpy() == np.arange(64))) >= 0.9


def test_per_subspace_reconstruction_beats_shared(subspace):
    _, q_sub, x = subspace
    q_shared = QuantizedHnsw.new(64, DenseSource(_t(x)), 4, Metric.EUCLIDEAN,
                                 pqp=q_sub.quantizer.pq_params, seed=4, exact_quantize=True,
                                 use_kmeans=True)

    def mse(q):
        return float(((q.quantizer.reconstruct(q.quantizer.quantize(_t(x), exact=True))
                       - _t(x)) ** 2).mean())

    assert mse(q_sub) <= mse(q_shared) * 1.05
