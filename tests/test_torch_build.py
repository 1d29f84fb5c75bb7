"""The port's bulk construction against the JAX package: ladder goldens, the
candidate pool on JAX's own random draws, and one generate_layer from an
identical stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import build as jb
from parallel_hnsw_tpu.graph import DenseSource as JaxSource
from parallel_hnsw_tpu.graph import Layer as JaxLayer
from parallel_hnsw_tpu.ops.distance import Metric as JaxMetric
from parallel_hnsw_tpu.params import BuildParams as JaxBuildParams
from parallel_hnsw_tpu_torch import build as tb
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import DenseSource
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import BuildParams

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)


def _jax_draws(key, n, c):
    """The uniform arrays JAX's _candidate_pool draws from ``key``."""
    k1, k2 = jax.random.split(key)
    u_exp = jax.random.uniform(k1, (n, c), minval=1e-7, maxval=1.0)
    u_mem = jax.random.uniform(k2, (n, c))
    return torch.from_numpy(np.array(u_exp)), torch.from_numpy(np.array(u_mem))


def test_partition_goldens():
    # reference: test_partitions_with_single_entry (src/lib.rs:2300-2304)
    assert len(tb.calculate_partitions(1, 24)) == 1
    assert tb.calculate_partitions_from_bottom(1000, 2) == [
        1000, 500, 250, 125, 62, 31, 15, 7, 3, 1,
    ]
    assert tb.calculate_partitions(9, 6) == [1, 9]
    assert tb.calculate_partitions(10000, 12) == [5, 69, 833, 10000]
    for total, order in [(200_000, 12), (1500, 12), (777, 6), (2**20, 24)]:
        assert tb.calculate_partitions(total, order) == jb.calculate_partitions(total, order)


@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_pool_bit_identical_on_jax_draws(seed):
    rng = np.random.default_rng(seed)
    n, s, c = 300, 6, 30
    seeds = rng.integers(0, n // 4, size=(n, s)).astype(np.int32)  # shared partitions
    seeds[rng.random((n, s)) < 0.3] = EMPTY_ID
    seeds[:7] = EMPTY_ID  # seedless nodes fall back to their own partition
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jb._candidate_pool(key, jnp.asarray(seeds), n, c))
    got = tb._candidate_pool(*_jax_draws(key, n, c), torch.from_numpy(seeds), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_draws_are_per_rung_and_in_range():
    a = tb.pool_draws(0, 100, 100, 8, "cpu")
    b = tb.pool_draws(0, 100, 100, 8, "cpu")
    c = tb.pool_draws(0, 101, 100, 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert float(a[0].min()) >= 1e-7 and float(a[0].max()) < 1.0
    assert float(a[1].min()) >= 0.0 and float(a[1].max()) < 1.0


@pytest.mark.parametrize("metric", ["normalized_cosine", "euclidean"])
def test_generate_layer_matches_jax_on_identical_stack(metric):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (500, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    # the stack comes from the port's raw ladder (no improve), so JAX compiles
    # only generate_layer; both packages then extend the identical stack
    bp = JaxBuildParams()
    stack = tb.generate(DenseSource(torch.from_numpy(x)), np.arange(500), BuildParams(), Metric(metric), seed=3)
    t_stack, bottom = stack[:-1], stack[-1]
    above = [JaxLayer(jnp.asarray(l.nodes.numpy()), jnp.asarray(l.neighbors.numpy())) for l in t_stack]
    key = jax.random.PRNGKey(11)
    m = bp.zero_layer_neighborhood_size
    want = jb.generate_layer(
        key, jnp.asarray(bottom.nodes.numpy()), m, above, JaxSource(jnp.asarray(x)), JaxMetric(metric),
        bp.initial_partition_search,
    )
    got = tb.generate_layer(
        _jax_draws(key, bottom.node_count, 5 * m), bottom.nodes,
        m, t_stack, DenseSource(torch.from_numpy(x)), Metric(metric),
        BuildParams().initial_partition_search,
    )
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    got_rows, want_rows = got.neighbors.numpy(), np.asarray(want.neighbors)
    same = [set(g) == set(w) for g, w in zip(got_rows, want_rows)]
    assert np.mean(same) >= 0.99, np.mean(same)


def test_top_layer_seeds_and_small_stack():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (40, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    source = DenseSource(torch.from_numpy(x))
    vs = torch.arange(40, dtype=torch.int32)
    layer = tb.generate_layer(
        tb.pool_draws(0, 40, 40, 30, "cpu"), vs, 6, [], source, Metric.NORMALIZED_COSINE,
        BuildParams().initial_partition_search,
    )
    nb = layer.neighbors.numpy()
    assert nb.shape == (40, 6)
    for i in range(40):
        row = nb[i][nb[i] != EMPTY_ID]
        assert len(row) > 0 and i not in row and len(set(row.tolist())) == len(row)

    ids, d = tb._seed_top_layer(vs, source, Metric.NORMALIZED_COSINE, 6, 6)
    j_ids, j_d = jb._seed_top_layer(
        jnp.arange(40), JaxSource(jnp.asarray(x)), JaxMetric.NORMALIZED_COSINE, 6, 6
    )
    np.testing.assert_allclose(d.numpy(), np.asarray(j_d), atol=1e-6)
    assert (ids.numpy() == np.asarray(j_ids)).mean() >= 0.99
