"""The plain reference against a NumPy brute force at tiny sizes, for each
metric the configurations use, and the TF32 rounding of the control."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import reference


def _numpy_distances(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if metric == "normalized_cosine":
        return (1.0 - q64 @ x64.T) / 2.0
    return np.sqrt(((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1))


def _draw(metric: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((17, 24)).astype(np.float32)
    if metric == "normalized_cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@pytest.mark.parametrize("metric", reference.METRICS)
def test_distances_match_numpy(metric):
    x, q = _draw(metric)
    got = reference.distances(torch.from_numpy(q), torch.from_numpy(x), metric).numpy()
    np.testing.assert_allclose(got, _numpy_distances(q, x, metric), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", reference.METRICS)
def test_exact_topk_matches_numpy(metric):
    x, q = _draw(metric, seed=1)
    want = _numpy_distances(q, x, metric)
    order = np.argsort(want, axis=1, kind="stable")[:, :10]
    # a block of 5 queries forces several blocks
    ids, dists = reference.exact_topk(torch.from_numpy(x), torch.from_numpy(q), metric, 10,
                                      block_bytes=5 * 4 * x.shape[0])
    np.testing.assert_array_equal(ids.numpy(), order)
    np.testing.assert_allclose(dists.numpy(), np.take_along_axis(want, order, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", reference.METRICS)
def test_pair_distances_match_numpy(metric):
    x, q = _draw(metric, seed=2)
    ids = np.random.default_rng(3).integers(0, x.shape[0], (q.shape[0], 10))
    got = reference.pair_distances(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(ids), metric)
    want = np.take_along_axis(_numpy_distances(q, x, metric), ids, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0 - 2.0**-12])
    got = reference.round_tf32(x)
    # ties go to the even mantissa
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2 * 2.0**-10, -3.0])
    assert torch.equal(got, want)
    y = torch.randn(1000)
    err = ((reference.round_tf32(y) - y).abs() / y.abs()).max()
    assert 0 < float(err) <= 2.0**-11
