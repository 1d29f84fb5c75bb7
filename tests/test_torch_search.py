"""The port's beam search against the JAX package on one identical graph: a
small JAX-built index converted with ``hnsw_from_numpy``, the same queries
through both ``search`` functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.graph import DenseSource as JaxSource
from parallel_hnsw_tpu.index import Hnsw as JaxHnsw
from parallel_hnsw_tpu.params import SearchParams as JaxSearchParams
from parallel_hnsw_tpu.params import params_to_dict
from parallel_hnsw_tpu.search import search as jax_search
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import hnsw_from_numpy
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.search import auto_query_block, search

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)

N, DIM, Q = 600, 16, 96


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(17)
    x = rng.uniform(-1, 1, (N + Q, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    corpus, queries = x[:N], x[N:]
    jh = JaxHnsw.generate(JaxSource(jnp.asarray(corpus)), metric="cosine", seed=2, improve=False)
    layers = [(np.asarray(l.nodes), np.asarray(l.neighbors)) for l in jh.layers]
    th = hnsw_from_numpy(layers, corpus, "cosine", params_to_dict(jh.build_parameters))
    return jh, th, queries


def _both(graphs, queries, sp, exclude=None):
    jh, th, _ = graphs
    j_ids, j_d = jax_search(
        jh.layers, jh.source, jh.metric, jnp.asarray(queries), JaxSearchParams(**vars(sp)),
        exclude=None if exclude is None else jnp.asarray(exclude),
    )
    t_ids, t_d = search(
        th.layers, th.source, th.metric, torch.from_numpy(queries), sp,
        exclude=None if exclude is None else torch.from_numpy(exclude),
    )
    return np.asarray(j_ids), np.asarray(j_d), t_ids.numpy(), t_d.numpy()


def _assert_close(j_ids, j_d, t_ids, t_d, k=10):
    # ids shared per row: last-bit distance differences (einsum vs matmul)
    # can reorder near-ties or, rarely, steer one query down another path
    shared = np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(j_ids, t_ids)])
    assert shared >= 0.995, shared
    same = j_ids[:, :k] == t_ids[:, :k]
    np.testing.assert_allclose(t_d[:, :k][same], j_d[:, :k][same], atol=1e-5)


@pytest.mark.parametrize(
    "sp",
    [SearchParams(), SearchParams(number_of_candidates=24, upper_layer_candidate_count=6, beam_width=1)],
    ids=["default", "narrow"],
)
def test_search_matches_jax(graphs, sp):
    j_ids, j_d, t_ids, t_d = _both(graphs, graphs[2], sp)
    assert t_ids.dtype == np.int32 and t_ids.shape == j_ids.shape
    _assert_close(j_ids, j_d, t_ids, t_d)


def test_exclude_matches_jax(graphs):
    queries = np.asarray(graphs[1].source.vectors[:Q].numpy())  # corpus rows as queries
    exclude = np.arange(Q, dtype=np.int32)
    sp = SearchParams(number_of_candidates=32, upper_layer_candidate_count=8)
    j_ids, j_d, t_ids, t_d = _both(graphs, queries, sp, exclude)
    assert not (t_ids == exclude[:, None]).any()
    assert ((t_ids == EMPTY_ID) == (j_ids == EMPTY_ID)).mean() >= 0.995
    _assert_close(j_ids, j_d, t_ids, t_d)


def test_query_blocks_give_the_same_result(graphs):
    _, th, queries = graphs
    sp = SearchParams(number_of_candidates=32)
    q = torch.from_numpy(queries)
    whole = search(th.layers, th.source, th.metric, q, sp)
    blocked = search(th.layers, th.source, th.metric, q, sp, query_block=40)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)
    assert auto_query_block(th.source, SearchParams(), 48) == 8192
