"""The port's sharded dense index on an 8-shard CPU mesh (mirrors every case
of tests/test_sharded.py, whose 8 virtual XLA devices become a ``Mesh`` that
names ``cpu`` eight times), plus parity with the JAX package: the scan-only
partition, search / search_exact / stochastic_recall of JAX's own
``ShardedHnsw`` over the port's stacked graphs, and the sharded files, byte
for byte in both directions."""

import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import io as jio
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource
from parallel_hnsw_tpu.graph import Layer as JLayer
from parallel_hnsw_tpu.ops.distance import Metric as JMetric
from parallel_hnsw_tpu.params import BuildParams as JBuildParams
from parallel_hnsw_tpu.params import OptimizationParams as JOptimizationParams
from parallel_hnsw_tpu.parallel import ShardedHnsw as JShardedHnsw
from parallel_hnsw_tpu.parallel import default_mesh as j_default_mesh
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    PqSource,
    SearchParams,
    deserialize_sharded_hnsw,
    serialize_sharded_hnsw,
)
from parallel_hnsw_tpu_torch.analysis import brute_force_knn
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import sharded_from_numpy, sharded_to_numpy
from parallel_hnsw_tpu_torch.ops.distance import pairwise_distance
from parallel_hnsw_tpu_torch.parallel import Mesh, ShardedHnsw, default_mesh
from parallel_hnsw_tpu_torch.pq import random_centroids

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)
J_BP = JBuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=JOptimizationParams(recall_proportion=1.0),
)
MESH = Mesh(["cpu"] * 8)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_eight_shard_cpu_mesh():
    """The 8-device mesh of the JAX suite: one device named eight times;
    the default mesh takes the CUDA devices, of which there are none here."""
    assert MESH.devices.size == 8 and MESH.axis_names == ("shard",)
    assert all(d == torch.device("cpu") for d in MESH.devices.flat)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_mesh()


@pytest.fixture(scope="module")
def sharded():
    vecs = _unit(410, 16, 13)  # not divisible by 8 → padding
    source = DenseSource(vectors=_t(vecs))
    sh = ShardedHnsw.generate(source, MESH, BP, Metric.NORMALIZED_COSINE, seed=0)
    return source, sh


def test_sharded_recall_vs_bruteforce(sharded):
    source, sh = sharded
    queries = source.vectors
    ids, _ = sh.search(queries, k=10)
    gt_ids, _ = brute_force_knn(source, queries, Metric.NORMALIZED_COSINE, 1)
    recall = float((ids[:, 0] == gt_ids[:, 0]).float().mean())
    assert recall >= 0.97, recall


def test_sharded_no_padding_leak(sharded):
    source, sh = sharded
    ids, _ = sh.search(source.vectors[:16], k=50)
    valid = ids[ids != EMPTY_ID]
    assert int(valid.min()) >= 0 and int(valid.max()) < source.count


def test_sharded_sorted_and_unique(sharded):
    source, sh = sharded
    ids, dists = sh.search(source.vectors[:8], k=20)
    for row_i, row_d in zip(ids.numpy(), dists.numpy()):
        fin = np.isfinite(row_d)
        assert np.all(np.diff(row_d[fin]) >= -1e-6)
        real = row_i[row_i != EMPTY_ID]
        assert len(np.unique(real)) == len(real)


def test_sharded_pq_source():
    """PQ-compressed shards: per-shard code arrays + a shared codebook, the
    100M-config layout at toy scale."""
    vecs = _unit(200, 16, 21)
    book = random_centroids(_t(vecs), 64, 4, seed=0)
    subs = _t(vecs).reshape(-1, 4)
    codes = torch.argmin(pairwise_distance(subs, book, Metric.SQUARED_EUCLIDEAN), dim=1)
    pq = PqSource(codes=codes.reshape(200, 4).to(torch.int32), codebook=book)
    sh = ShardedHnsw.generate(pq, MESH, BP, Metric.EUCLIDEAN, seed=0)
    ids, _ = sh.search(_t(vecs[:32]), k=5)
    valid = ids[ids != EMPTY_ID]
    assert valid.numel() > 0 and int(valid.max()) < 200
    hits = float((ids[:, 0] == torch.arange(32)).float().mean())
    assert hits > 0.5, hits


def test_sharded_stochastic_recall(sharded):
    _, sh = sharded
    r = sh.stochastic_recall()
    assert 0.9 <= r <= 1.0, r


def test_sharded_roundtrip(tmp_path, sharded):
    source, sh = sharded
    serialize_sharded_hnsw(sh, tmp_path / "sh")
    back = deserialize_sharded_hnsw(tmp_path / "sh", sh.mesh)
    assert back.n_shards == sh.n_shards
    assert torch.equal(back.global_ids, sh.global_ids)
    q = source.vectors[:16]
    i1, d1 = sh.search(q, k=10)
    i2, d2 = back.search(q, k=10)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(d1, d2, atol=1e-6, rtol=0)


def test_sharded_flat_scan_exact_and_fast(sharded):
    """search_exact: per-shard flat scans + the merge find the true nearest
    neighbors across the whole sharded corpus."""
    source, sh = sharded
    queries = source.vectors[:24]
    gt = brute_force_knn(source, queries, sh.metric, 5)[0].numpy()
    for fast in (False, True):
        ids, _ = sh.search_exact(queries, k=5, fast=fast)
        got = ids[:, :5].numpy()
        recall = np.mean([len(np.intersect1d(got[i], gt[i])) for i in range(24)]) / 5
        assert recall >= 0.99, (fast, recall)
        assert (got[:, 0] == np.arange(24)).mean() >= 0.95


def test_shard_builds_are_standalone_builds():
    """Per-shard determinism is (seed + shard)-only: each shard's stacked
    levels are those of ``Hnsw.generate`` run alone on the shard's rows with
    ``seed + s`` (bottom-aligned; the stack pads nodes and neighbors and may
    replicate a shorter ladder's top).  ``parallel_build`` is taken for the
    JAX signature: shards build in order either way."""
    vecs = _unit(300, 16, 21)
    sh = ShardedHnsw.generate(DenseSource(vectors=_t(vecs)), MESH, BP,
                              Metric.NORMALIZED_COSINE, seed=3, parallel_build=True)
    per = -(-300 // 8)
    for s in range(8):
        rows = np.arange(s, 300, 8)
        real = len(rows)
        rows = np.concatenate([rows, np.repeat(rows[-1:], per - real)])
        alone = Hnsw.generate(DenseSource(vectors=_t(vecs[rows])), np.arange(real), BP,
                              Metric.NORMALIZED_COSINE, seed=3 + s)
        stacked = sh._shard_hnsw(s).layers
        assert len(stacked) >= alone.layer_count
        for la, ls in zip(alone.layers[::-1], stacked[::-1]):
            n, m = la.neighbors.shape
            assert torch.equal(ls.nodes, la.nodes)
            assert torch.equal(ls.neighbors[:, :m], la.neighbors)
            assert bool((ls.neighbors[:, m:] == EMPTY_ID).all())
        assert torch.equal(sh.global_ids[s, :real], _t(rows[:real].astype(np.int32)))


def test_improve_index_keeps_every_shard_valid():
    """improve_index on an index built without it: each shard improves on its
    own, the stacks keep every shard's ladder valid, and a second call on the
    converged index changes nothing (no level is re-stacked)."""
    vecs = _unit(300, 16, 5)
    sh = ShardedHnsw.generate(DenseSource(vectors=_t(vecs)), MESH, BP,
                              Metric.NORMALIZED_COSINE, seed=1, improve=False)
    r = sh.improve_index()
    assert 0.9 <= r <= 1.0, r
    for s in range(sh.n_shards):
        sh._shard_hnsw(s).assert_invariants()
    sh.improve_index()
    kept = [id(l) for h in sh._shards for l in h.layers]
    stacked = sh.layers_stacked
    sh.improve_index()
    if all(torch.equal(a.neighbors, b.neighbors) for a, b in zip(stacked, sh.layers_stacked)):
        assert [id(l) for h in sh._shards for l in h.layers] == kept


# ---------------------------------------------------------------------------
# parity with the JAX package


@pytest.fixture(scope="module")
def jax_twin(sharded):
    """JAX's own ShardedHnsw over the port's stacked graphs, source and
    global ids (no JAX graph is built)."""
    _, sh = sharded
    state = sharded_to_numpy(sh)
    layers = [JLayer(jnp.asarray(n), jnp.asarray(nb)) for n, nb in state["layers"]]
    jsh = JShardedHnsw(j_default_mesh(), layers, JDenseSource(vectors=jnp.asarray(state["vectors"])),
                       jnp.asarray(state["global_ids"]), JMetric.NORMALIZED_COSINE, J_BP)
    jsh.place()
    return jsh


def test_scan_only_partition_matches_jax():
    """generate(build_graphs=False) of both packages: the same round-robin
    partition, padding and stacked source."""
    vecs = _unit(410, 16, 13)
    jsh = JShardedHnsw.generate(JDenseSource(vectors=jnp.asarray(vecs)), j_default_mesh(),
                                metric=JMetric.NORMALIZED_COSINE, build_graphs=False)
    sh = ShardedHnsw.generate(DenseSource(vectors=_t(vecs)), MESH,
                              metric=Metric.NORMALIZED_COSINE, build_graphs=False)
    assert sh.layers_stacked == [] and jsh.layers_stacked == []
    np.testing.assert_array_equal(sh.global_ids.numpy(), np.asarray(jsh.global_ids))
    np.testing.assert_array_equal(sh.source_stacked.vectors.numpy(),
                                  np.asarray(jsh.source_stacked.vectors))


def test_convert_carries_the_stacks_both_ways(sharded, jax_twin):
    _, sh = sharded
    back = sharded_from_numpy(sharded_to_numpy(jax_twin), MESH)
    for la, lb in zip(back.layers_stacked, sh.layers_stacked):
        assert torch.equal(la.nodes, lb.nodes) and torch.equal(la.neighbors, lb.neighbors)
    assert torch.equal(back.source_stacked.vectors, sh.source_stacked.vectors)
    assert torch.equal(back.global_ids, sh.global_ids)


def test_search_matches_jax_on_the_same_graphs(sharded, jax_twin):
    source, sh = sharded
    q = source.vectors[:64]
    ids, dists = sh.search(q, k=10)
    j_ids, j_d = jax_twin.search(jnp.asarray(q.numpy()), k=10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(j_d), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_search_exact_matches_jax(sharded, jax_twin, fast):
    """Exact: ids equal, distances within 1e-5.  Fast: ids equal as sets at
    equal distance (the port's survivor cut is an exact top-k, JAX's
    ``approx_min_k``)."""
    source, sh = sharded
    q = source.vectors[100:148]
    ids, dists = sh.search_exact(q, k=5, fast=fast)
    j_ids, j_d = jax_twin.search_exact(jnp.asarray(q.numpy()), k=5, fast=fast)
    j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)
    np.testing.assert_allclose(dists.numpy(), j_d, atol=1e-5, rtol=0)
    if not fast:
        np.testing.assert_array_equal(ids.numpy(), j_ids)
    for row, j_row, d in zip(ids.numpy(), j_ids, dists.numpy()):
        # the ids may trade places only among equal distances
        assert set(row) == set(j_row) or np.unique(d).size < d.size


def test_stochastic_recall_matches_jax(sharded, jax_twin):
    _, sh = sharded
    assert sh.stochastic_recall() == jax_twin.stochastic_recall()
    op = OptimizationParams(recall_proportion=0.25,
                            search=SearchParams(number_of_candidates=4, upper_layer_candidate_count=4))
    j_op = JOptimizationParams(recall_proportion=0.25, search=J_BP.optimization.search.replace(
        number_of_candidates=4, upper_layer_candidate_count=4))
    assert sh.stochastic_recall(op, seed=7) == jax_twin.stochastic_recall(j_op, seed=7)


def _same_files(a: Path, b: Path) -> None:
    names_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    names_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert names_a == names_b
    for name in names_a:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_sharded_files_byte_identical_both_ways(sharded, jax_twin, tmp_path):
    """Both packages write the same bytes; each reads what the other wrote."""
    source, sh = sharded
    serialize_sharded_hnsw(sh, tmp_path / "port")
    jio.serialize_sharded_hnsw(jax_twin, tmp_path / "jax")
    _same_files(tmp_path / "port", tmp_path / "jax")
    q = source.vectors[:16]
    from_jax = deserialize_sharded_hnsw(tmp_path / "jax", MESH)
    i1, d1 = sh.search(q, k=10)
    i2, d2 = from_jax.search(q, k=10)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    from_port = jio.deserialize_sharded_hnsw(tmp_path / "port", j_default_mesh())
    np.testing.assert_array_equal(np.asarray(from_port.global_ids), sh.global_ids.numpy())
    for la, lb in zip(from_port.layers_stacked, sh.layers_stacked):
        np.testing.assert_array_equal(np.asarray(la.neighbors), lb.neighbors.numpy())
