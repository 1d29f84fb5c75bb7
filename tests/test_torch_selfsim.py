"""The port's all-pairs self-similarity (knn / threshold_nn) against the
reference's goldens and the JAX package (mirrors the knn and threshold_nn
cases of tests/test_selfsim.py; the graph diagnostics there wait for their
slice).  One graph: the port builds the nine-vector index and ``convert``
hands JAX the stack."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.graph import DenseSource as JDenseSource, Layer as JLayer
from parallel_hnsw_tpu.index import Hnsw as JHnsw
from parallel_hnsw_tpu.params import build_params_from_dict as j_build_params_from_dict
from parallel_hnsw_tpu_torch import BuildParams, DenseSource, Hnsw, Metric, OptimizationParams
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import hnsw_to_numpy

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

R = 1.0 / math.sqrt(2.0)
DATA = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [R, R, 0.0],
        [0.5773, 0.5773, 0.5773],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, R, R],
    ],
    dtype=np.float32,
)

BP = BuildParams(
    order=6,
    neighborhood_size=3,
    zero_layer_neighborhood_size=6,
    optimization=OptimizationParams(recall_proportion=1.0),
)


@pytest.fixture(scope="module")
def hnsw():
    source = DenseSource(torch.from_numpy(DATA))
    return Hnsw.generate(source, np.arange(9), BP, Metric.COSINE, seed=1)


@pytest.fixture(scope="module")
def jax_hnsw(hnsw):
    layers, vectors, metric, bp_dict = hnsw_to_numpy(hnsw)
    return JHnsw(
        [JLayer(nodes=jnp.asarray(n), neighbors=jnp.asarray(nb)) for n, nb in layers],
        JDenseSource(vectors=jnp.asarray(vectors)), metric, j_build_params_from_dict(bp_dict),
    )


def test_knn_golden(hnsw):
    # reference: test_knn (src/lib.rs:2358-2377), k=1, probe_depth=1
    vec_ids, nn_ids, nn_d = hnsw.knn(1, probe_depth=1)
    assert isinstance(nn_ids, np.ndarray) and nn_ids.dtype == np.int32
    want = {0: (3, 0.29289323), 1: (3, 0.29289323), 2: (8, 0.29289323),
            3: (4, 0.1835745), 4: (3, 0.1835745), 5: (1, 1.0),
            6: (0, 1.0), 7: (0, 1.0), 8: (4, 0.1835745)}
    for i, v in enumerate(vec_ids.tolist()):
        wid, wd = want[v]
        assert nn_ids[i, 0] == wid, (v, nn_ids[i], wid)
        np.testing.assert_allclose(nn_d[i, 0], wd, atol=1e-6)


def test_threshold_nn_golden(hnsw):
    # reference: test_threshold_nn (src/lib.rs:2379-2420), threshold=0.3
    vec_ids, nn_ids, nn_d = hnsw.threshold_nn(0.3, probe_depth=1)
    want = {
        0: [(3, 0.29289323)],
        1: [(3, 0.29289323), (8, 0.29289323)],
        2: [(8, 0.29289323)],
        3: [(4, 0.1835745), (0, 0.29289323), (1, 0.29289323)],
        4: [(3, 0.1835745), (8, 0.1835745)],
        5: [],
        6: [],
        7: [],
        8: [(4, 0.1835745), (1, 0.29289323), (2, 0.29289323)],
    }
    for i, v in enumerate(vec_ids.tolist()):
        got = [
            (int(nn_ids[i, j]), float(nn_d[i, j]))
            for j in range(nn_ids.shape[1])
            if nn_ids[i, j] != EMPTY_ID
        ]
        expect = want[v]
        assert [g[0] for g in got] == [w[0] for w in expect], (v, got, expect)
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in expect], atol=1e-6)


@pytest.mark.parametrize("k,probe_depth,query_block", [(1, 1, 0), (3, 2, 0), (2, 2, 4)])
def test_knn_matches_jax(hnsw, jax_hnsw, k, probe_depth, query_block):
    """Same graph, same queue capacity: ids equal, distances atol 1e-6 (nine
    3-d unit vectors: a few f32 ulps of values <= 2)."""
    got = hnsw.knn(k, probe_depth=probe_depth, query_block=query_block)
    want = jax_hnsw.knn(k, probe_depth=probe_depth, query_block=query_block)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1].shape == (9, k) and got[2].shape == (9, k)
    same = got[1] == np.asarray(want[1])
    # equidistant neighbors (0.29289323 twice) may swap under another rounding
    tied = np.isclose(got[2], np.asarray(want[2]), atol=1e-6)
    assert (same | tied).all() and same.mean() >= 0.8
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-6)


@pytest.mark.parametrize("threshold", [0.3, 1.01])
def test_threshold_nn_matches_jax(hnsw, jax_hnsw, threshold):
    got = hnsw.threshold_nn(threshold, probe_depth=1)
    want = jax_hnsw.threshold_nn(threshold, probe_depth=1)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1].shape == np.asarray(want[1]).shape
    for i in range(9):
        assert set(got[1][i].tolist()) == set(np.asarray(want[1])[i].tolist()), i
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-6)


def test_threshold_nn_dense_cluster_per_node_doubling():
    """One tight cluster must not force a whole-corpus re-scan per doubling:
    covered nodes retire and only the cluster re-searches, with the output
    semantics unchanged (mirror of the JAX package's test)."""
    rng = np.random.default_rng(7)
    sparse = rng.normal(size=(48, 4)).astype(np.float32)
    sparse /= np.linalg.norm(sparse, axis=1, keepdims=True)
    center = sparse[0]
    cluster = center[None, :] + rng.normal(scale=1e-3, size=(12, 4)).astype(np.float32)
    cluster /= np.linalg.norm(cluster, axis=1, keepdims=True)
    data = np.concatenate([sparse, cluster]).astype(np.float32)

    bp = BuildParams(
        order=6,
        neighborhood_size=4,
        zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    h = Hnsw.generate(DenseSource(torch.from_numpy(data)), np.arange(len(data)), bp,
                      Metric.COSINE, seed=2)
    searched = []
    real = h._bottom_layer_self_search_idx
    h._bottom_layer_self_search_idx = lambda idx, cap, sp: (searched.append((len(idx), cap)),
                                                           real(idx, cap, sp))[1]
    threshold = 1e-4
    vec_ids, nn_ids, nn_d = h.threshold_nn(threshold, probe_depth=4, initial_search_depth=4)
    # ground truth: cosine distances under the threshold
    gt = 1.0 - data @ data.T
    for i, v in enumerate(vec_ids.tolist()):
        want = set(np.nonzero((gt[v] < threshold))[0].tolist()) - {v}
        got = set(int(x) for x in nn_ids[i] if x != EMPTY_ID)
        assert got == want, (v, got, want)
    # the first round searches everything, later rounds only the uncovered rest
    assert searched[0] == (60, 4) and len(searched) >= 2
    assert all(n < 60 for n, _ in searched[1:])
    assert [c for _, c in searched] == [4 * 2**i for i in range(len(searched))]
    assert nn_ids.shape[1] == searched[-1][1] and np.isinf(nn_d[nn_ids == EMPTY_ID]).all()
