"""The port on a CUDA card: the hand-written kernel against its plain version,
its launch counts and input checks, and a small build and search on the
device.  Every test is marked ``cuda`` and skips where no card is present.

This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from parallel_hnsw_tpu_torch import BuildParams, DenseSource, Hnsw, Metric
from parallel_hnsw_tpu_torch.ops import cuda_distance
from parallel_hnsw_tpu_torch.ops.distance import pairwise_distance

pytestmark = pytest.mark.cuda

# (Q, C, D, rtol): the JAX kernel test's shapes are held to its atol 2e-5
# alone; at the others the L2 family reaches |x|^2 + |y|^2 ~ 200, where two
# fp32 summation orders differ by a few ulps (1 ulp = 1.5e-5 there), so they
# also get a relative bound of ~8 ulps.
SHAPES = [(70, 130, 32, 0), (1, 3, 7, 0), (64, 128, 16, 1e-6), (129, 67, 100, 1e-6), (300, 1000, 5, 1e-6)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _pair(q, c, d, device, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(device),
            torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)).to(device))


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_kernel_matches_plain(device, metric):
    for q, c, d, rtol in SHAPES:
        x, y = _pair(q, c, d, device)
        want = pairwise_distance(x, y, metric)
        before = dict(cuda_distance.LAUNCHES)
        for exact in (True, False):
            got = cuda_distance.best_pairwise_distance(x, y, metric, exact=exact)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=2e-5, rtol=rtol)
        assert cuda_distance.LAUNCHES["exact"] == before["exact"] + 1
        assert cuda_distance.LAUNCHES["fast"] == before["fast"] + 1


def test_wrapper_rejects_bad_operands(device):
    x, y = _pair(8, 8, 16, device)
    with pytest.raises(TypeError):
        cuda_distance.cuda_pairwise_distance(x.double(), y.double(), Metric.DOT)
    with pytest.raises(ValueError):
        cuda_distance.cuda_pairwise_distance(x, y[:, :8], Metric.DOT)
    with pytest.raises(ValueError):
        cuda_distance.cuda_pairwise_distance(x.T, y, Metric.DOT)
    assert cuda_distance.cuda_pairwise_distance(x[:0], y, Metric.DOT).shape == (0, 8)


def test_tf32_is_refused(device, monkeypatch):
    x, y = _pair(8, 8, 16, device)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        pairwise_distance(x, y, Metric.DOT)


def test_build_and_search_on_device(device):
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (3100, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    vecs = torch.from_numpy(x).to(device)
    source, queries = DenseSource(vecs[:3000]), vecs[3000:]
    before = cuda_distance.LAUNCHES["exact"]
    hnsw = Hnsw.generate(source, bp=BuildParams(), metric=Metric.NORMALIZED_COSINE, seed=1)
    assert cuda_distance.LAUNCHES["exact"] > before
    hnsw.assert_invariants()
    gt, gt_d = hnsw.search_exact(queries, k=10)
    ids, dists = hnsw.search(queries)
    assert ids.device == device and ids.dtype == torch.int32
    recall = float((ids[:, :10, None] == gt[:, None, :]).any(-1).float().mean())
    assert recall >= 0.95
    assert hnsw.stochastic_recall() >= 0.99
    # exact search on the card agrees with the plain version's full sort
    full = pairwise_distance(queries, source.vectors, Metric.NORMALIZED_COSINE)
    want_d, _ = torch.sort(full, dim=-1)
    torch.testing.assert_close(gt_d, want_d[:, :10], atol=1e-6, rtol=0)
