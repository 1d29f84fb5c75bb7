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
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_dots_plain_version_matches_jax(metric, shape):
    """The fast mode's plain version against the JAX package on operands
    rounded to bf16 with jnp: directly for the dot metrics; for the L2 family
    through its dots plus jnp norms of the UNROUNDED f32 operands, which is
    what the Pallas kernel's fast mode sums.  Both sides add the same exact
    products (bf16 x bf16 fits f32) in f32, so they differ only by summation
    order: atol 2e-5, the JAX kernel test's own bound at these shapes."""
    x, y = _pair(*shape)
    xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    yb = jnp.asarray(y).astype(jnp.bfloat16).astype(jnp.float32)
    if metric in (td.Metric.EUCLIDEAN, td.Metric.SQUARED_EUCLIDEAN):
        dots = -jd.pairwise_distance(xb, yb, "dot")
        x2 = jnp.sum(jnp.asarray(x) ** 2, axis=-1, keepdims=True)
        y2 = jnp.sum(jnp.asarray(y) ** 2, axis=-1)[None, :]
        want = jnp.maximum(x2 + y2 - 2.0 * dots, 0.0)
        want = jnp.sqrt(want) if metric is td.Metric.EUCLIDEAN else want
    else:
        want = jd.pairwise_distance(xb, yb, metric.value)
    got = td.pairwise_distance_bf16_dots(torch.from_numpy(x), torch.from_numpy(y), metric)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if shape[2] >= 16:  # and it IS a rounded product: not the fp32 distances
        exact = td.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric)
        assert float((got - exact).abs().max()) > 1e-4


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_cpu_dispatch_is_fp32_in_both_modes(metric):
    """On a CPU tensor ``exact=False`` is the fp32 plain version, as the JAX
    package's ``Precision.DEFAULT`` is fp32 on a CPU."""
    x, y = map(torch.from_numpy, _pair(70, 130, 32))
    fast = cuda_distance.best_pairwise_distance(x, y, metric, exact=False)
    assert torch.equal(fast, cuda_distance.best_pairwise_distance(x, y, metric, exact=True))
    assert torch.equal(fast, td.pairwise_distance(x, y, metric))


@pytest.mark.parametrize("d", [7, 100, 128])
def test_padded_bf16_copies_keep_dots_and_norms(d):
    """``bf16_rows`` / ``plain_bf16_operand`` / ``prepare_operand`` /
    ``scan_operand``: the bf16 rounding of the rows, zero columns up to a
    multiple of 8, so no dot and no norm moves."""
    from parallel_hnsw_tpu_torch.ops import cuda_scan

    x, y = map(torch.from_numpy, _pair(9, 21, d))
    xr, yr = cuda_distance.bf16_rows(x), cuda_distance.bf16_rows(y)
    wide = d + -d % 8
    assert xr.shape == (9, wide) and xr.dtype == torch.bfloat16 and xr.is_contiguous()
    assert torch.equal(xr[:, :d], x.to(torch.bfloat16)) and not bool(xr[:, d:].any())
    dots = xr.double() @ yr.double().T
    assert torch.equal(dots, x.to(torch.bfloat16).double() @ y.to(torch.bfloat16).double().T)
    assert cuda_distance.bf16_rows(xr) is xr or torch.equal(cuda_distance.bf16_rows(xr), xr)
    rows, norms = cuda_distance.plain_bf16_operand(y, with_norms=True)
    assert torch.equal(rows, yr) and torch.equal(norms, torch.sum(y * y, dim=-1))
    assert cuda_distance.plain_bf16_operand(y)[1] is None
    # on the CPU both modes are fp32: nothing is made, slices are views of the values
    op = cuda_distance.prepare_operand(y, td.Metric.EUCLIDEAN, exact=False)
    assert op.values is y and op.rows is None and op.sq_norms is None
    part = op.narrow(4, 13)
    assert torch.equal(part.values, y[4:13]) and part.rows is None
    got = cuda_distance.best_pairwise_distance(x, part, td.Metric.EUCLIDEAN, exact=False)
    assert torch.equal(got, td.pairwise_distance(x, y[4:13], td.Metric.EUCLIDEAN))
    with pytest.raises(ValueError):
        cuda_distance.cuda_bf16_operand(y)
    # on the CPU the scans' operand is the cast alone (the plain versions need no padding)
    assert torch.equal(cuda_scan.scan_operand(y), y.to(torch.bfloat16))


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
