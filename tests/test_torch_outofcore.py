"""The port's out-of-core source (mirrors tests/test_outofcore.py:55-104): a
``MemmapSource`` corpus on disk that never reaches a device as a whole, its
host ``source_get``, a ``QuantizedHnsw`` built by streaming from it, and
``exact_rerank`` gathering candidate rows on the host, against the JAX
package's on the same numpy ids; plus the rest of the source seam on a host
source (distances, width, densifying, the flat scan, persistence) and
centroids that do not depend on whether a tensor or a memmap holds the rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import graph as jgraph
from parallel_hnsw_tpu import routing as jrouting
from parallel_hnsw_tpu.ops.distance import Metric as JMetric
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    MemmapSource,
    Metric,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
    fast_flat_knn,
    open_memmap_source,
)
from parallel_hnsw_tpu_torch import graph as tgraph
from parallel_hnsw_tpu_torch import io as tio
from parallel_hnsw_tpu_torch import pq as tpq
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.ops.distance import batched_distance
from parallel_hnsw_tpu_torch.pq import QuantizedHnsw
from parallel_hnsw_tpu_torch.routing import exact_rerank

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)
PQP = PqBuildParams(
    centroids=BP,
    hnsw=BP,
    quantized_search=SearchParams(number_of_candidates=32, upper_layer_candidate_count=32),
)


def _write_memmap(tmp_path, count, dim, seed):
    """A unit-vector corpus written to disk; its MemmapSource and the rows."""
    arr = np.random.default_rng(seed).normal(size=(count, dim)).astype(np.float32)
    arr /= np.linalg.norm(arr, axis=1, keepdims=True)
    path = tmp_path / "corpus.f32"
    arr.tofile(path)
    return open_memmap_source(str(path), dim), arr


def test_open_memmap_source(tmp_path):
    mm, arr = _write_memmap(tmp_path, 64, 8, seed=1)
    assert isinstance(mm.vectors, np.memmap)
    assert mm.count == 64 and mm.dim == 8 and tgraph.is_host_source(mm)
    np.testing.assert_array_equal(np.asarray(mm.vectors), arr)
    # chunk iteration covers every row in order, in bounded chunks
    chunks = list(mm.chunks(chunk_size=10))
    assert max(len(c) for c in chunks) == 10
    np.testing.assert_array_equal(np.concatenate(chunks), arr)
    # subset iteration fetches exactly the requested rows, in order
    ids = np.asarray([3, 1, 60, 60])
    np.testing.assert_array_equal(np.concatenate(list(mm.chunks(chunk_size=3, ids=ids))), arr[ids])
    # the same chunks as the JAX package's
    j_mm = jgraph.open_memmap_source(str(tmp_path / "corpus.f32"), 8)
    for got, want in zip(mm.chunks(7, ids=ids), j_mm.chunks(7, ids=ids)):
        np.testing.assert_array_equal(got, want)


def test_memmap_source_get(tmp_path):
    """The host gather: numpy fancy indexing of the clipped ids, then one
    copy to the device named (default: the ids' device)."""
    mm, arr = _write_memmap(tmp_path, 32, 8, seed=2)
    ids = np.array([[0, 5], [31, 2], [EMPTY_ID, -3]], np.int32)
    want = np.asarray(jgraph.source_get(jgraph.MemmapSource(vectors=arr), jnp.asarray(ids)))
    got = tgraph.source_get(mm, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == (3, 2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tgraph.source_get(mm, ids, device="cpu").numpy(), want)


def test_host_source_seam(tmp_path):
    """Every function that takes a source has a host branch: distances go
    through the host gather (+inf off the corpus), the width is the dense
    one, densifying copies the rows to the device named, and an unknown
    kind raises."""
    mm, arr = _write_memmap(tmp_path, 40, 8, seed=3)
    q = torch.from_numpy(arr[:4])
    ids = torch.tensor([[0, 1, EMPTY_ID], [39, 2, -1], [5, 5, 6], [7, 8, 9]], dtype=torch.int32)
    got = tgraph.source_distance(mm, q, ids, Metric.EUCLIDEAN)
    want = tgraph.source_distance(DenseSource(vectors=torch.from_numpy(arr)), q, ids,
                                  Metric.EUCLIDEAN)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert bool(torch.isinf(got[0, 2])) and bool(torch.isinf(got[1, 2]))
    assert tgraph.source_effective_width(mm) == jgraph.source_effective_width(
        jgraph.MemmapSource(vectors=arr))
    dense = tgraph.materialize_source(mm, block=16, device="cpu")
    np.testing.assert_array_equal(dense.numpy(), arr)
    with pytest.raises(TypeError, match="unknown source type"):
        tgraph.source_distance(object(), q, ids, Metric.EUCLIDEAN)
    with pytest.raises(tio.SerializationError, match="external store"):
        tio.serialize_source(mm, tmp_path / "comparator")


@pytest.mark.parametrize("metric", [Metric.EUCLIDEAN, Metric.NORMALIZED_COSINE])
def test_exact_rerank_on_a_host_source_matches_jax(tmp_path, metric):
    """The host branch gathers each query block's candidate rows from the
    memmap and moves only that block: the same ids as the JAX package's on
    the same numpy ids, distances within 1e-6, over several blocks."""
    mm, arr = _write_memmap(tmp_path, 300, 16, seed=4)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 300, (40, 12)).astype(np.int32)
    ids[:, -2:] = EMPTY_ID
    queries = rng.normal(size=(40, 16)).astype(np.float32)
    budget = 16 * 12 * 128 * 4  # 16-query blocks
    j_ids, j_d = jrouting.exact_rerank(jgraph.MemmapSource(vectors=arr), JMetric(metric.value),
                                       jnp.asarray(queries), jnp.asarray(ids), block_budget=budget)
    t_ids, t_d = exact_rerank(mm, metric, torch.from_numpy(queries), torch.from_numpy(ids),
                              block_budget=budget)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-6, rtol=0)
    # and the device branch over the same rows gives the same answer
    d_ids, d_d = exact_rerank(DenseSource(vectors=torch.from_numpy(arr)), metric,
                              torch.from_numpy(queries), torch.from_numpy(ids), block_budget=budget)
    assert torch.equal(d_ids, t_ids) and torch.equal(d_d, t_d)


def test_fast_flat_knn_streams_a_host_source(tmp_path):
    """The flat scan over a memmap gathers each corpus block on the host: the
    same answer as over the dense rows."""
    mm, arr = _write_memmap(tmp_path, 300, 16, seed=6)
    q = torch.from_numpy(arr[:20])
    got = fast_flat_knn(mm, q, Metric.NORMALIZED_COSINE, 5, corpus_block=64)
    want = fast_flat_knn(DenseSource(vectors=torch.from_numpy(arr)), q, Metric.NORMALIZED_COSINE,
                         5, corpus_block=64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_quantized_hnsw_from_memmap(tmp_path):
    """A single PQ index built by streaming chunks from disk: the full source
    stays the memmap, codes and graphs land on the device named, and the
    exact rerank gathers true rows from disk."""
    mm, arr = _write_memmap(tmp_path, 300, 16, seed=23)
    q = QuantizedHnsw.new(
        number_of_centroids=64, full_source=mm, dsub=4, metric=Metric.EUCLIDEAN, pqp=PQP, seed=3,
        exact_quantize=True,
        chunk_size=64,  # several streamed chunks
        device="cpu",
    )
    assert isinstance(q.full_source, MemmapSource)
    assert q.hnsw.source.codes.dtype == torch.uint16 and q.hnsw.source.device.type == "cpu"
    queries = torch.from_numpy(arr[:48])
    ids, dists = q.search(queries, exact_quantize=True)
    hit = ids[:, 0] == torch.arange(48)
    assert float(hit.float().mean()) >= 0.9
    assert bool((dists[hit, 0].abs() < 1e-4).all())
    ids2, d2 = q.search_exact(queries, k=5, rerank=True)
    assert float((ids2[:, 0] == torch.arange(48)).float().mean()) >= 0.95
    want = batched_distance(queries, torch.from_numpy(arr)[ids2.long()], Metric.EUCLIDEAN)
    torch.testing.assert_close(d2, want, atol=1e-6, rtol=0)
    # the same codes as a build over the dense rows
    dense = QuantizedHnsw.new(
        number_of_centroids=64, full_source=DenseSource(vectors=torch.from_numpy(arr)), dsub=4,
        metric=Metric.EUCLIDEAN, pqp=PQP, seed=3, exact_quantize=True, chunk_size=64,
    )
    assert torch.equal(q.hnsw.source.codes.view(torch.int16),
                       dense.hnsw.source.codes.view(torch.int16))


def test_per_subspace_kmeans_from_memmap_samples_on_the_host(tmp_path):
    """Per-subspace k-means codebooks from a memmap: each subspace's sample is
    read on the host, with the codebooks of a build over the dense rows."""
    mm, arr = _write_memmap(tmp_path, 200, 16, seed=8)
    kw = dict(number_of_centroids=16, dsub=4, metric=Metric.EUCLIDEAN, pqp=PQP, seed=2,
              per_subspace=True, use_kmeans=True, kmeans_sample=120, chunk_size=50)
    a = QuantizedHnsw.new(full_source=mm, device="cpu", **kw)
    b = QuantizedHnsw.new(full_source=DenseSource(vectors=torch.from_numpy(arr)), **kw)
    assert torch.equal(a.quantizer.codebooks, b.quantizer.codebooks)
    assert torch.equal(a.hnsw.source.codes.view(torch.int16), b.hnsw.source.codes.view(torch.int16))


def test_random_centroids_agree_between_a_memmap_and_a_tensor(tmp_path):
    """The same rows give the same centroids from a memmap and from a
    tensor, even where distinct sub-vectors tie on the dedup hash: both
    paths read the sample in ascending row order, so the hash sort's stable
    order of tied rows is the same."""
    rng = np.random.default_rng(10)
    pairs = rng.integers(1, 60, (60, 2)).astype(np.float32) / 64
    rows = np.concatenate([pairs, pairs[:, ::-1]], axis=1)  # (a, b, b, a): (a, b) ties (b, a)
    rows = rows[rng.permutation(60)]
    rows.tofile(tmp_path / "rows.f32")
    mm = open_memmap_source(str(tmp_path / "rows.f32"), 4)
    projection = torch.ones(2)  # a + b: every (a, b) ties its (b, a)
    kw = dict(n_centroids=50, dsub=2, seed=4, projection=projection)
    got = tpq.random_centroids(mm.vectors, device="cpu", **kw)
    want = tpq.random_centroids(torch.from_numpy(rows), **kw)
    assert torch.equal(got, want)
