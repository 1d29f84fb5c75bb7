"""The port on a CUDA card: each hand-written kernel against its plain version,
their launch counts and input checks, a small build and search, the flat scan
and a persistence round trip on the device.  Every test is marked ``cuda``
and skips where no card is present.

This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from parallel_hnsw_tpu_torch import BuildParams, DenseSource, Hnsw, Metric, analysis
from parallel_hnsw_tpu_torch.ops import cuda_distance, cuda_scan
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


# -- the binned and folded scan kernels ---------------------------------------

# (Q, C, D, tile_c, n_slots): the JAX kernel tests' shapes, then ragged ones
SCAN_SHAPES = [(16, 300, 8, 256, 4), (16, 1500, 8, 256, 4), (24, 3000, 16, 256, 8),
               (70, 1000, 100, 128, 3), (129, 5000, 33, 512, 32)]


def _unit_pair(q, c, d, device, seed=3):
    x, y = _pair(q, c, d, device, seed)
    return x / x.norm(dim=1, keepdim=True), y / y.norm(dim=1, keepdim=True)


def _assert_bins_agree(got, want, x, y, metric, exact):
    """Distances within 1e-5 (unit vectors of D <= 100: a few f32 ulps of
    values <= 4).  Columns identical, except that two summation orders may
    swap a near-tie: there the plain distance at the kernel's column must be
    within the same tolerance of the plain minimum."""
    (got_d, got_c), (want_d, want_c) = got, want
    assert got_d.dtype == torch.float32 and got_c.dtype == torch.int32
    fin = torch.isfinite(want_d)
    assert torch.equal(torch.isfinite(got_d), fin)
    torch.testing.assert_close(got_d[fin], want_d[fin], atol=1e-5, rtol=0)
    # padding bins report the same columns too
    differ = got_c != want_c
    assert float(differ.float().mean()) < 0.001
    if bool(differ.any()):
        assert bool(fin[differ].all())
        xs, ys = (x, y) if exact else (x.bfloat16().float(), y.bfloat16().float())
        full = pairwise_distance(xs, ys, metric)
        rows = differ.nonzero()[:, 0]
        torch.testing.assert_close(full[rows, got_c[differ].long()], want_d[differ],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_scan_kernels_match_plain(device, metric, exact):
    for q, c, d, tile_c, n_slots in SCAN_SHAPES:
        x, y = _unit_pair(q, c, d, device)
        before = dict(cuda_scan.LAUNCHES)
        got = cuda_scan.binned_scan(x, y, metric, tile_c=tile_c, exact=exact)
        torch.cuda.synchronize()
        want = cuda_scan.plain_binned_scan(x, y, metric, tile_c=tile_c, exact=exact)
        assert got[0].shape == (q, -(-c // tile_c) * 128)
        _assert_bins_agree(got, want, x, y, metric, exact)
        got = cuda_scan.folded_scan(x, y, metric, tile_c=tile_c, n_slots=n_slots, exact=exact)
        torch.cuda.synchronize()
        want = cuda_scan.plain_folded_scan(x, y, metric, tile_c=tile_c, n_slots=n_slots,
                                           exact=exact)
        assert got[0].shape == (q, cuda_scan.fold_shape(c, tile_c, n_slots)[0] * 128)
        _assert_bins_agree(got, want, x, y, metric, exact)
        assert cuda_scan.LAUNCHES == {"binned": before["binned"] + 1,
                                      "folded": before["folded"] + 1}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_scan_kernels_take_the_first_index_on_ties(device, exact):
    base, x = _unit_pair(128, 6, 8, device)
    y = torch.cat([base] * 8)  # class l holds row l eight times
    lane = torch.arange(128, device=device)
    for metric in (Metric.NORMALIZED_COSINE, Metric.SQUARED_EUCLIDEAN):
        cols = cuda_scan.cuda_binned_scan(x, y, metric, tile_c=256, exact=exact)[1]
        want = (torch.arange(4, device=device)[:, None] * 256 + lane).reshape(1, -1).int()
        assert torch.equal(cols, want.expand(6, -1))
        cols = cuda_scan.cuda_folded_scan(x, y, metric, tile_c=256, n_slots=2, exact=exact)[1]
        want = (torch.arange(2, device=device)[:, None] * 512 + lane).reshape(1, -1).int()
        assert torch.equal(cols, want.expand(6, -1))


def test_scan_wrappers_reject_bad_operands(device):
    x, y = _pair(8, 300, 16, device)
    with pytest.raises(TypeError):
        cuda_scan.cuda_binned_scan(x.double(), y.double(), Metric.DOT, tile_c=256, exact=True)
    with pytest.raises(TypeError):
        cuda_scan.cuda_folded_scan(x.bfloat16(), y.bfloat16(), Metric.DOT, tile_c=256, exact=True)
    with pytest.raises(ValueError):
        cuda_scan.cuda_binned_scan(x, y[:, :8], Metric.DOT, tile_c=256, exact=True)
    with pytest.raises(ValueError):
        cuda_scan.cuda_folded_scan(x, y.T.contiguous().T, Metric.DOT, tile_c=256, exact=True)
    with pytest.raises(ValueError):
        cuda_scan.cuda_binned_scan(x, y, Metric.DOT, tile_c=100, exact=True)
    with pytest.raises(ValueError):
        cuda_scan.cuda_binned_scan(x, y.cpu(), Metric.DOT, tile_c=256, exact=True)
    assert cuda_scan.cuda_binned_scan(x[:0], y, Metric.DOT, tile_c=256)[0].shape == (0, 256)


@pytest.mark.parametrize("mode", ["exhaustive", "binned", "folded"])
def test_fast_flat_knn_on_device(device, mode):
    x, y = _unit_pair(200, 20000, 32, device, seed=5)
    source = DenseSource(y)
    gt, gt_d = analysis.brute_force_knn(source, x, Metric.EUCLIDEAN, 10)
    before = dict(cuda_scan.LAUNCHES)
    ids, d = analysis.fast_flat_knn(source, x, Metric.EUCLIDEAN, 10, oversample=8,
                                    query_block=128, scan_mode=mode)
    ran = {k: cuda_scan.LAUNCHES[k] - before[k] for k in before}
    assert ran == {"binned": 2 * (mode == "binned"), "folded": 2 * (mode == "folded")}
    recall = float((ids[:, :, None] == gt[:, None, :]).any(-1).float().mean())
    assert recall >= (1.0 if mode == "exhaustive" else 0.97)
    hit = ids == gt
    torch.testing.assert_close(d[hit], gt_d[hit], atol=1e-5, rtol=0)
    assert bool((d[:, 1:] >= d[:, :-1]).all())


def test_persistence_lands_on_the_card(device, tmp_path):
    from parallel_hnsw_tpu_torch import deserialize_hnsw, serialize_hnsw
    from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus

    source = random_unit_corpus(2000, 16)  # no device named: the card
    assert source.device.type == "cuda"
    hnsw = Hnsw.generate(source, metric=Metric.NORMALIZED_COSINE, seed=1)
    serialize_hnsw(hnsw, tmp_path / "idx")
    loaded = deserialize_hnsw(tmp_path / "idx")
    assert loaded.source.device.type == "cuda"
    (i1, d1), (i2, d2) = hnsw.search(source.vectors[:50]), loaded.search(source.vectors[:50])
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
