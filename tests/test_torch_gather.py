"""The port's row gathers against the JAX package's plain reference.

``scripts/gather_kernel_study.py`` holds its Pallas kernel to
``jnp.take(corpus, idx, axis=0)``; the port's dispatch and plain version are
held to the same call here, on the CPU, with exact equality (a gather is a
copy).  The hop's gather-and-distance is held to the JAX package's own hop
computation, ``batched_distance(q, jnp.take(table, idx))``.  The CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.graph import DenseSource as JaxSource
from parallel_hnsw_tpu.graph import source_get as jax_source_get
from parallel_hnsw_tpu.ops.distance import batched_distance as jax_batched_distance
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import DenseSource, gather_features, source_distance, source_get
from parallel_hnsw_tpu_torch.ops import cuda_gather
from parallel_hnsw_tpu_torch.ops.cuda_gather import (
    gather_distance,
    plain_gather_distance,
    plain_row_gather,
    row_gather,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric

torch.set_num_threads(1)

N = 257


def _tables(kind):
    """The same table as a numpy array for JAX and a tensor for the port."""
    rng = np.random.default_rng(7)
    if kind == "f32":
        a = rng.normal(size=(N, 100)).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)
    if kind == "int32":
        a = rng.integers(0, 2**31 - 1, size=(N, 24)).astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    if kind == "slab":
        a = rng.normal(size=(N, 6, 10)).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)
    # bf16: both packages round the same f32 values to nearest even
    a = rng.normal(size=(N, 64)).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["f32", "bf16", "int32", "slab"])
@pytest.mark.parametrize("shape", [(1,), (300,), (7, 5), (2, 3, 4), (0,)], ids=str)
def test_row_gather_equals_jnp_take(kind, shape):
    jt, tt = _tables(kind)
    rng = np.random.default_rng(len(shape))
    idx = rng.integers(0, N, size=shape).astype(np.int32)
    if idx.size >= 3:
        idx.reshape(-1)[:3] = [0, N - 1, N - 1]  # both ends, a repeat
    want = _jax_bits(jnp.take(jt, jnp.asarray(idx), axis=0))
    for fn in (row_gather, plain_row_gather):
        got = fn(tt, torch.from_numpy(idx))
        assert got.dtype == tt.dtype and got.shape == (*shape, *tt.shape[1:])
        np.testing.assert_array_equal(_bits(got), want)


def test_row_gather_takes_index_views():
    _, tt = _tables("f32")
    idx = torch.from_numpy(np.random.default_rng(3).integers(0, N, size=(12, 9)).astype(np.int32))
    for view in (idx.T, idx[:, ::2], idx[3]):
        assert torch.equal(row_gather(tt, view), tt[view.long()])


def test_row_gather_checks_its_operands():
    _, tt = _tables("f32")
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        row_gather(tt, idx.long())
    with pytest.raises(ValueError):
        row_gather(tt[:, 0], idx)
    with pytest.raises(ValueError):
        row_gather(tt.to("meta"), idx.to("meta"))  # neither a CUDA nor a CPU tensor
    # the kernel's wrapper takes CUDA tensors only: a CPU tensor reaches the
    # plain version through the dispatch and nothing else
    with pytest.raises(ValueError):
        cuda_gather.cuda_row_gather(tt, idx)
    before = dict(cuda_gather.LAUNCHES)
    row_gather(tt, idx)
    assert cuda_gather.LAUNCHES == before  # the plain version counts no launch


def test_source_get_clamps_like_jax():
    jt, tt = _tables("f32")
    ids = np.array([[0, 5, EMPTY_ID], [N - 1, N, 3]], dtype=np.int32)
    want = np.asarray(jax_source_get(JaxSource(jt), jnp.asarray(ids)))
    got = source_get(DenseSource(tt), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    # int64 ids (topk positions) are taken too
    np.testing.assert_array_equal(source_get(DenseSource(tt), torch.from_numpy(ids).long()).numpy(), want)
    flat = torch.from_numpy(np.arange(N, dtype=np.int32))
    assert torch.equal(gather_features(DenseSource(tt), flat, block=100), tt)


# -- the hop's gather-and-distance -----------------------------------------------

# Unit rows and queries: every dot and squared distance is at most 4, where two
# f32 summation orders of 100 terms (JAX's einsum, torch's matmul or sum)
# differ by a few ulps of 4 (4.8e-7 each): 1e-5 holds them with room.
HOP_ATOL = 1e-5


def _hop_inputs(layout, dtype):
    """``(queries [Q, D], table, idx [Q, K])`` as numpy: unit rows, ``table``
    ``[N, D]`` (one row per index) or a hop slab ``[N, M, D]`` (M rows per
    index); the indices repeat and reach both ends of the table."""
    rng = np.random.default_rng(11)
    n, shape, d = (N, (N,), 100) if layout == "rows" else (40, (40, 6), 33)
    table = rng.normal(size=(*shape, d)).astype(np.float32)
    table /= np.linalg.norm(table, axis=-1, keepdims=True)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    idx = rng.integers(0, n, size=(6, 7 if layout == "rows" else 3)).astype(np.int32)
    idx[0, :3] = [0, n - 1, n - 1]
    idx[3, :] = 5  # one row asked for K times
    return queries, table, idx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["rows", "slab"])
@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_gather_distance_matches_jax_hop(metric, layout, dtype):
    """Indices in the table; those outside are held to +inf below."""
    queries, table, idx = _hop_inputs(layout, dtype)
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    if dtype == "bf16":  # both packages round the same f32 values to nearest even
        jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    q, k = idx.shape
    cands = jnp.take(jt, jnp.asarray(idx), axis=0).reshape(q, -1, table.shape[-1])
    want = np.asarray(jax_batched_distance(jnp.asarray(queries), cands, metric.value))
    assert want.shape == (q, k * (1 if layout == "rows" else table.shape[1]))
    before = dict(cuda_gather.LAUNCHES)
    for fn in (gather_distance, plain_gather_distance):
        got = fn(torch.from_numpy(queries), tt, torch.from_numpy(idx), metric)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=HOP_ATOL, rtol=0)
    assert cuda_gather.LAUNCHES == before  # CPU tensors take the plain version


def test_source_distance_gives_inf_outside_the_source():
    """The hop's plain-source branch: ids of the source get the JAX hop's
    distances, ``EMPTY_ID`` and ids past the end ``+inf`` (the hop masks
    them to ``+inf`` in both packages)."""
    queries, table, _ = _hop_inputs("rows", "f32")
    ids = np.array([[0, 5, EMPTY_ID], [N - 1, N, 3]] * 3, dtype=np.int32)
    inside = ids < N
    jt = jnp.asarray(table)
    want = np.asarray(jax_batched_distance(
        jnp.asarray(queries), jax_source_get(JaxSource(jt), jnp.asarray(np.where(inside, ids, 0))),
        "squared_euclidean"))
    got = source_distance(DenseSource(torch.from_numpy(table)), torch.from_numpy(queries),
                          torch.from_numpy(ids), Metric.SQUARED_EUCLIDEAN).numpy()
    np.testing.assert_allclose(got[inside], want[inside], atol=HOP_ATOL, rtol=0)
    assert np.isinf(got[~inside]).all() and (got[~inside] > 0).all()


def test_gather_distance_checks_its_operands():
    queries, table, idx = (torch.from_numpy(a) for a in _hop_inputs("rows", "f32"))
    metric = Metric.DOT
    with pytest.raises(ValueError, match="no gather-distance path"):
        gather_distance(queries.to("meta"), table.to("meta"), idx.to("meta"), metric)
    # the kernel's wrapper takes CUDA tensors only
    with pytest.raises(ValueError):
        cuda_gather.cuda_gather_distance(queries, table, idx, metric)
    with pytest.raises(TypeError):
        gather_distance(queries, table, idx.long(), metric)
    with pytest.raises(TypeError):
        gather_distance(queries.double(), table, idx, metric)
    with pytest.raises(TypeError):
        gather_distance(queries, table.to(torch.int32), idx, metric)
    with pytest.raises(ValueError):
        gather_distance(queries, table[:, :50], idx, metric)
    with pytest.raises(ValueError):
        gather_distance(queries, table, idx[:3], metric)
    assert gather_distance(queries, table, idx[:, :0], metric).shape == (6, 0)
