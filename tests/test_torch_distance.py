"""The port's distance ops and kernel dispatch against the JAX package.

On the CPU the dispatch takes the plain version; the CUDA kernel itself is
checked on a card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.ops import distance as jd
from parallel_hnsw_tpu.ops.pallas_distance import pallas_pairwise_distance
from parallel_hnsw_tpu_torch.ops import _native, cuda_distance
from parallel_hnsw_tpu_torch.ops import distance as td

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)

METRICS = list(td.Metric)
SHAPES = [(70, 130, 32), (1, 3, 7), (64, 128, 16)]


def _pair(q, c, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pairwise_matches_jax(metric, shape):
    x, y = _pair(*shape)
    tile_q = 64 if shape[0] > 8 else 8
    want_kernel = np.asarray(pallas_pairwise_distance(
        jnp.asarray(x), jnp.asarray(y), metric.value, tile_q=tile_q, tile_c=128, interpret=True
    ))
    want_xla = np.asarray(jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric.value))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for exact in (True, False):
        plain = td.pairwise_distance(xt, yt, metric, exact=exact).numpy()
        best = cuda_distance.best_pairwise_distance(xt, yt, metric, exact=exact).numpy()
        for got in (plain, best):
            np.testing.assert_allclose(got, want_kernel, atol=2e-5)
            np.testing.assert_allclose(got, want_xla, atol=2e-5)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_batched_and_paired_match_jax(metric):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(5, 3, 24)).astype(np.float32)
    cands = rng.normal(size=(5, 3, 17, 24)).astype(np.float32)
    b = rng.normal(size=(5, 3, 24)).astype(np.float32)
    np.testing.assert_allclose(
        td.batched_distance(torch.from_numpy(q), torch.from_numpy(cands), metric).numpy(),
        np.asarray(jd.batched_distance(jnp.asarray(q), jnp.asarray(cands), metric.value)),
        atol=2e-5,
    )
    np.testing.assert_allclose(
        td.distance_one(torch.from_numpy(q), torch.from_numpy(b), metric).numpy(),
        np.asarray(jd.distance_one(jnp.asarray(q), jnp.asarray(b), metric.value)),
        atol=2e-5,
    )


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_batched_distance_widens_bf16_candidates_like_jax(metric):
    """bf16 routing rows against f32 queries: both packages widen the rows and
    accumulate in f32, so unit vectors agree within atol 1e-6 (one f32 ulp of
    sums of magnitude <= 4 under another summation order)."""
    rng = np.random.default_rng(12)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c = rng.normal(size=(6, 9, 16)).astype(np.float32)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    got = td.batched_distance(torch.from_numpy(q), torch.from_numpy(c).to(torch.bfloat16), metric)
    want = jd.batched_distance(jnp.asarray(q), jnp.asarray(c).astype(jnp.bfloat16), metric.value)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # and the result is that of the widened rows, not of rounded queries
    wide = td.batched_distance(torch.from_numpy(q), torch.from_numpy(c).to(torch.bfloat16).float(), metric)
    assert torch.equal(got, wide)


def test_cuda_wrapper_rejects_cpu_tensors():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_distance.cuda_pairwise_distance(x, x, td.Metric.COSINE)


def test_native_load_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_nvcc", lambda: None)
    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR / "absent-in-this-test")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.load()
