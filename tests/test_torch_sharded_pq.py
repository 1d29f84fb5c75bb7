"""The port's sharded PQ index, in core and out of core, on an 8-shard CPU
mesh (mirrors tests/test_outofcore.py's sharded cases: never materializing
f32, self-hit, flat scan, in-core = out-of-core, streamed codes = in-core
codes, the round trip, scan-only, per-subspace), plus parity with the JAX
package: given JAX's own centroid draws the codes are bit-identical to
``ShardedQuantizedHnsw.new(exact_quantize=True, build_graphs=False)``'s, and
``search_exact`` returns the same ids."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.graph import open_memmap_source as j_open_memmap_source
from parallel_hnsw_tpu.ops.distance import Metric as JMetric
from parallel_hnsw_tpu.params import BuildParams as JBuildParams
from parallel_hnsw_tpu.params import OptimizationParams as JOptimizationParams
from parallel_hnsw_tpu.params import PqBuildParams as JPqBuildParams
from parallel_hnsw_tpu.params import SearchParams as JSearchParams
from parallel_hnsw_tpu.parallel import ShardedQuantizedHnsw as JShardedQuantizedHnsw
from parallel_hnsw_tpu.parallel import default_mesh as j_default_mesh
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Metric,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
    deserialize_sharded_hnsw,
    deserialize_sharded_quantized_hnsw,
    open_memmap_source,
    serialize_sharded_hnsw,
    serialize_sharded_quantized_hnsw,
)
from parallel_hnsw_tpu_torch.analysis import brute_force_knn
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.io import SerializationError
from parallel_hnsw_tpu_torch.ops.distance import batched_distance
from parallel_hnsw_tpu_torch.parallel import Mesh, ShardedHnsw, ShardedQuantizedHnsw
from parallel_hnsw_tpu_torch.pq import SubspaceQuantizer

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
MESH = Mesh(["cpu"] * 8)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _write_memmap(tmp_path, count, dim, seed):
    """A unit-vector corpus written to disk; its MemmapSource and the rows."""
    arr = _unit(count, dim, seed)
    path = tmp_path / "corpus.f32"
    arr.tofile(path)
    return open_memmap_source(str(path), dim), arr


def _codes(sq) -> np.ndarray:
    return sq.sharded.source_stacked.codes.view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(scope="module")
def ooc(tmp_path_factory):
    """Out-of-core sharded PQ index over an 8-shard mesh: the f32 corpus on
    disk, u16 codes at dsub=4 (an 8x compression) on the shards, and no
    ``full_stacked``."""
    tmp_path = tmp_path_factory.mktemp("ooc")
    mm, arr = _write_memmap(tmp_path, 410, 16, seed=13)  # ragged → padding
    sq = ShardedQuantizedHnsw.new(
        number_of_centroids=64, full_source=mm, dsub=4, metric=Metric.EUCLIDEAN, mesh=MESH,
        pqp=PQP, seed=3, exact_quantize=True,
        chunk_size=16,  # each shard streams its rows in several chunks
        improve=False,  # graph quality is not under test
    )
    return mm, arr, sq


def test_out_of_core_never_materializes_f32(ooc):
    mm, arr, sq = ooc
    assert sq.full_stacked is None
    assert sq.full_host is mm
    codes = sq.sharded.source_stacked.codes
    assert codes.dtype == torch.uint16
    assert codes.numel() * 2 < arr.nbytes / 2
    for s in range(sq.sharded.n_shards):  # only codes on the shards' devices
        assert sq.sharded.shard_source(s).codes.dtype == torch.uint16


def test_out_of_core_search_self_hit(ooc):
    mm, arr, sq = ooc
    queries = torch.from_numpy(arr[:64])
    ids, dists = sq.search(queries, k=5, exact_quantize=True)
    valid = ids[ids != EMPTY_ID]
    assert valid.numel() > 0 and int(valid.max()) < mm.count
    hit = ids[:, 0] == torch.arange(64)
    assert float(hit.float().mean()) >= 0.9
    # distances are exact full precision (host-gathered rows) after rerank
    assert bool((dists[hit, 0].abs() < 1e-4).all())


def test_out_of_core_flat_scan(ooc):
    _, arr, sq = ooc
    ids, _ = sq.search_exact(torch.from_numpy(arr[:32]), k=5, fast=False)
    assert float((ids[:, 0] == torch.arange(32)).float().mean()) >= 0.95


def test_search_exact_in_core_matches_out_of_core(tmp_path):
    """With ``oversample * k`` covering the corpus both reranks see every row,
    so both residency modes return the exact brute-force answer: any
    code-distance leak in either rerank breaks the equality."""
    mm, arr = _write_memmap(tmp_path, 250, 16, seed=11)
    kw = dict(number_of_centroids=48, dsub=4, metric=Metric.EUCLIDEAN, mesh=MESH, pqp=PQP,
              seed=3, exact_quantize=True, chunk_size=16, improve=False)
    ooc_idx = ShardedQuantizedHnsw.new(full_source=mm, **kw)
    inc_idx = ShardedQuantizedHnsw.new(full_source=DenseSource(vectors=torch.from_numpy(arr)), **kw)
    assert inc_idx.full_stacked is not None
    queries = torch.from_numpy(arr[:40])
    i_in, d_in = inc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    i_out, d_out = ooc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    assert torch.equal(i_in, i_out)
    torch.testing.assert_close(d_in, d_out, atol=1e-5, rtol=0)
    gt_ids, _ = brute_force_knn(DenseSource(vectors=torch.from_numpy(arr)), queries,
                                Metric.EUCLIDEAN, 5)
    assert torch.equal(i_in, gt_ids)
    # true f32 distances (self-distance 0), not code reconstructions; held
    # against the direct difference form (the scan's |x|^2 + |y|^2 - 2x.y
    # puts an ulp under the root near 0)
    want = batched_distance(queries, torch.from_numpy(arr)[gt_ids.long()], Metric.EUCLIDEAN)
    torch.testing.assert_close(d_in, want, atol=1e-5, rtol=0)


def test_out_of_core_matches_in_core_codes(tmp_path):
    """Per-shard streamed quantization assigns the in-core path's codes
    (same codebook, same rows) and the same partition."""
    mm, arr = _write_memmap(tmp_path, 72, 16, seed=7)
    kw = dict(number_of_centroids=32, dsub=4, metric=Metric.EUCLIDEAN, mesh=MESH, pqp=PQP,
              seed=3, exact_quantize=True, chunk_size=4, improve=False)
    a = ShardedQuantizedHnsw.new(full_source=mm, **kw)
    b = ShardedQuantizedHnsw.new(full_source=DenseSource(vectors=torch.from_numpy(arr)), **kw)
    np.testing.assert_array_equal(_codes(a), _codes(b))
    assert torch.equal(a.sharded.global_ids, b.sharded.global_ids)


def test_out_of_core_roundtrip(tmp_path, ooc):
    mm, arr, sq = ooc
    serialize_sharded_quantized_hnsw(sq, tmp_path / "sq")
    meta = json.loads((tmp_path / "sq" / "meta").read_text())
    assert meta["out_of_core"] is True
    assert "full_path" in meta  # the memmap's file, recorded as a reload hint
    back = deserialize_sharded_quantized_hnsw(tmp_path / "sq", MESH)
    q = torch.from_numpy(arr[:16])
    i1, d1 = sq.search(q, k=5, exact_quantize=True)
    i2, d2 = back.search(q, k=5, exact_quantize=True)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(d1, d2, atol=1e-6, rtol=0)
    back2 = deserialize_sharded_quantized_hnsw(tmp_path / "sq", MESH, full_source=mm)
    assert torch.equal(i1, back2.search(q, k=5, exact_quantize=True)[0])
    # without a store the external rows are missing
    meta["full_path"] = str(tmp_path / "gone.f32")
    (tmp_path / "sq" / "meta").write_text(json.dumps(meta))
    with pytest.raises(SerializationError, match="full_source"):
        deserialize_sharded_quantized_hnsw(tmp_path / "sq", MESH)


def test_scan_only_build(tmp_path):
    """build_graphs=False: no shard graphs (the config-5 serving shape: the
    flat code scan is the engine); flat scans and the round trip work, the
    graph paths raise."""
    mm, arr = _write_memmap(tmp_path, 96, 8, seed=9)
    sq = ShardedQuantizedHnsw.new(
        number_of_centroids=16, full_source=mm, dsub=4, metric=Metric.EUCLIDEAN, mesh=MESH,
        pqp=PQP, seed=3, exact_quantize=True, chunk_size=8, build_graphs=False,
    )
    assert sq.full_stacked is None and sq.sharded.layers_stacked == []
    q = torch.from_numpy(arr[:24])
    ids, _ = sq.search_exact(q, k=3, fast=False, oversample=8)
    assert float((ids[:, 0] == torch.arange(24)).float().mean()) == 1.0
    with pytest.raises(ValueError, match="scan-only"):
        sq.sharded.search(q)
    with pytest.raises(ValueError, match="scan-only"):
        sq.sharded.improve_index()

    # dense scan-only + persistence round trip
    src = DenseSource(vectors=torch.from_numpy(_unit(64, 8, 4)))
    sh = ShardedHnsw.generate(src, MESH, metric=Metric.NORMALIZED_COSINE, build_graphs=False)
    i1, _ = sh.search_exact(src.vectors[:16], k=3)
    serialize_sharded_hnsw(sh, tmp_path / "scan_only")
    back = deserialize_sharded_hnsw(tmp_path / "scan_only", MESH)
    assert back.layers_stacked == []
    i2, _ = back.search_exact(src.vectors[:16], k=3)
    assert torch.equal(i1, i2)


def test_sharded_per_subspace(tmp_path):
    """Per-subspace PQ in BOTH residency modes: a SubspaceQuantizer (no
    centroid graph), the [nsub, K, dsub] codebook through the shards'
    PqSources, streamed codes = in-core codes, exact answers from both
    reranks, the code-graph search, and the nested round trip."""
    mm, arr = _write_memmap(tmp_path, 230, 16, seed=21)
    kw = dict(number_of_centroids=32, dsub=4, metric=Metric.EUCLIDEAN, mesh=MESH, pqp=PQP,
              seed=3, chunk_size=16, improve=False, per_subspace=True)
    ooc_idx = ShardedQuantizedHnsw.new(full_source=mm, **kw)
    inc_idx = ShardedQuantizedHnsw.new(full_source=DenseSource(vectors=torch.from_numpy(arr)), **kw)
    for idx in (ooc_idx, inc_idx):
        assert isinstance(idx.quantizer, SubspaceQuantizer)
        assert tuple(idx.quantizer.codebooks.shape) == (4, 32, 4)
        assert idx.sharded.source_stacked.codebook.dim() == 3
    assert ooc_idx.full_stacked is None and inc_idx.full_stacked is not None
    np.testing.assert_array_equal(_codes(ooc_idx), _codes(inc_idx))

    queries = torch.from_numpy(arr[:40])
    i_in, d_in = inc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    i_out, d_out = ooc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    assert torch.equal(i_in, i_out)
    torch.testing.assert_close(d_in, d_out, atol=1e-5, rtol=0)
    assert float((i_in[:, 0] == torch.arange(40)).float().mean()) == 1.0

    ids, _ = ooc_idx.search(queries, k=5)
    assert float((ids[:, 0] == torch.arange(40)).float().mean()) >= 0.9
    ids, _ = inc_idx.search(queries, k=5)
    assert float((ids[:, 0] == torch.arange(40)).float().mean()) >= 0.9

    serialize_sharded_quantized_hnsw(ooc_idx, tmp_path / "sq_sub")
    qmeta = json.loads((tmp_path / "sq_sub" / "quantizer" / "pq_build_parameters.json").read_text())
    assert qmeta["quantizer_kind"] == "subspace"
    back = deserialize_sharded_quantized_hnsw(tmp_path / "sq_sub", MESH, full_source=mm)
    assert isinstance(back.quantizer, SubspaceQuantizer)
    assert torch.equal(i_out, back.search_exact(queries, k=5, fast=False, oversample=64)[0])
    # the in-core rows go through `full` and come back
    serialize_sharded_quantized_hnsw(inc_idx, tmp_path / "sq_inc")
    back = deserialize_sharded_quantized_hnsw(tmp_path / "sq_inc", MESH)
    assert torch.equal(back.full_stacked, inc_idx.full_stacked)
    assert torch.equal(i_in, back.search_exact(queries, k=5, fast=False, oversample=64)[0])


# ---------------------------------------------------------------------------
# parity with the JAX package


@pytest.mark.parametrize("residency", ["in_core", "out_of_core"])
def test_codes_and_search_exact_match_jax(tmp_path, residency):
    """Given JAX's own dedup projection and shuffle keys, the port's
    ``new(exact_quantize=True, build_graphs=False)`` picks JAX's centroids and
    assigns its codes bit for bit, with the same partition; ``search_exact``
    returns the same ids, distances within 1e-5."""
    mm, arr = _write_memmap(tmp_path, 230, 16, seed=17)
    seed, k_cent, dsub = 3, 64, 4
    key = jax.random.PRNGKey(seed)
    projection = torch.from_numpy(np.array(jax.random.normal(key, (dsub,), jnp.float32)))
    n_sub = min(k_cent, 230) * 16 // dsub
    shuffle = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 1), (n_sub,))))
    j_bp = JBuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                        optimization=JOptimizationParams(recall_proportion=1.0))
    j_pqp = JPqBuildParams(centroids=j_bp, hnsw=j_bp, quantized_search=JSearchParams(
        number_of_candidates=32, upper_layer_candidate_count=32))
    if residency == "in_core":
        from parallel_hnsw_tpu.graph import DenseSource as JDenseSource

        j_src, src = JDenseSource(vectors=jnp.asarray(arr)), DenseSource(vectors=torch.from_numpy(arr))
    else:
        j_src, src = j_open_memmap_source(str(tmp_path / "corpus.f32"), 16), mm
    j_sq = JShardedQuantizedHnsw.new(k_cent, j_src, dsub, JMetric.EUCLIDEAN, j_default_mesh(),
                                     pqp=j_pqp, seed=seed, exact_quantize=True, chunk_size=32,
                                     build_graphs=False)
    sq = ShardedQuantizedHnsw.new(k_cent, src, dsub, Metric.EUCLIDEAN, MESH, pqp=PQP, seed=seed,
                                  exact_quantize=True, chunk_size=32, build_graphs=False,
                                  projection=projection, shuffle=shuffle)
    np.testing.assert_array_equal(sq.quantizer.centroids.numpy(),
                                  np.asarray(j_sq.quantizer.centroids))
    np.testing.assert_array_equal(_codes(sq), np.asarray(j_sq.sharded.source_stacked.codes))
    np.testing.assert_array_equal(sq.sharded.global_ids.numpy(), np.asarray(j_sq.sharded.global_ids))
    if residency == "in_core":
        np.testing.assert_array_equal(sq.full_stacked.numpy(), np.asarray(j_sq.full_stacked))
    q = arr[100:132]
    ids, dists = sq.search_exact(torch.from_numpy(q), k=5, fast=False)
    j_ids, j_d = j_sq.search_exact(jnp.asarray(q), k=5, fast=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(j_d), atol=1e-5, rtol=0)

