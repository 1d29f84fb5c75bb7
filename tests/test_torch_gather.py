"""The port's row gather against the JAX package's plain reference.

``scripts/gather_kernel_study.py`` holds its Pallas kernel to
``jnp.take(corpus, idx, axis=0)``; the port's dispatch and plain version are
held to the same call here, on the CPU, with exact equality (a gather is a
copy).  The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.graph import DenseSource as JaxSource
from parallel_hnsw_tpu.graph import source_get as jax_source_get
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import DenseSource, gather_features, source_get
from parallel_hnsw_tpu_torch.ops import cuda_gather
from parallel_hnsw_tpu_torch.ops.cuda_gather import plain_row_gather, row_gather

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
