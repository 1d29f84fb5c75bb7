"""The port's binned and folded scans against the JAX package.

On the CPU the dispatches take the plain versions (the CUDA kernels are held
against the same plain versions on a card by tests/test_torch_cuda.py), so
these tests pin the plain versions to the Pallas kernels run in interpret
mode, on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.ops import distance as jd
from parallel_hnsw_tpu.ops.pallas_scan import pallas_binned_scan, pallas_folded_scan
from parallel_hnsw_tpu_torch.ops import cuda_scan
from parallel_hnsw_tpu_torch.ops.cuda_scan import LANES
from parallel_hnsw_tpu_torch.ops.distance import Metric, pairwise_distance

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

METRICS = list(Metric)
# Both sides sum D <= 16 products of unit-vector components in f32 (in other
# orders) and apply the same epilogue: a few ulps of values <= 4, the JAX
# kernel test's own bound.
ATOL = 1e-5


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _numpy_binned(d, tile_c):
    """The binning of tests/test_pallas_scan.py on a finished distance matrix."""
    q, c = d.shape
    cp = -(-c // tile_c) * tile_c
    d = np.concatenate([d, np.full((q, cp - c), np.inf, np.float32)], axis=-1)
    d4 = d.reshape(q, cp // tile_c, tile_c // LANES, LANES)
    g = d4.argmin(axis=2)
    cols = (np.arange(cp // tile_c) * tile_c)[None, :, None] + g * LANES + np.arange(LANES)
    return d4.min(axis=2).reshape(q, -1), cols.reshape(q, -1)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_plain_binned_exact_matches_pallas_and_numpy(metric):
    x, y = _unit(16, 8, 3), _unit(300, 8, 4)  # 2 tiles of 256, the second ragged
    want_d, want_c = pallas_binned_scan(
        jnp.asarray(x), jnp.asarray(y), metric.value, tile_q=8, tile_c=256,
        interpret=True, exact=True,
    )
    full = np.asarray(jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric.value))
    np_d, np_c = _numpy_binned(full, 256)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for fn in (cuda_scan.plain_binned_scan, cuda_scan.binned_scan):
        got_d, got_c = fn(xt, yt, metric, tile_c=256, exact=True)
        assert got_d.dtype == torch.float32 and got_c.dtype == torch.int32
        # padding classes report +inf and column j * tile_c + lane on both sides
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=ATOL)
        np.testing.assert_array_equal(got_c.numpy(), np_c)
        np.testing.assert_allclose(got_d.numpy(), np_d, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_plain_binned_fast_matches_pallas_on_bf16(metric):
    """Fast mode: both sides round the operands to bf16 and sum in f32.  The
    JAX side is the Pallas kernel in interpret mode on bf16 inputs (the XLA
    twin sums its norms in bf16).  Columns must agree wherever the class's
    runner-up is further than the tolerance from its minimum."""
    x, y = _unit(16, 8, 5), _unit(700, 8, 6)
    want_d, want_c = pallas_binned_scan(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), metric.value,
        tile_q=8, tile_c=256, interpret=True, exact=False,
    )
    want_d, want_c = np.asarray(want_d), np.asarray(want_c)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got_d, got_c = cuda_scan.binned_scan(xt, yt, metric, tile_c=256, exact=False)
    got_d, got_c = got_d.numpy(), got_c.numpy()
    np.testing.assert_allclose(got_d, want_d, atol=ATOL)
    differ = got_c != want_c
    if differ.any():
        full = pairwise_distance(xt.bfloat16().float(), yt.bfloat16().float(), metric).numpy()
        rows = np.nonzero(differ)[0]
        np.testing.assert_allclose(
            full[rows, got_c[differ]], full[rows, want_c[differ]], atol=ATOL
        )
    assert differ.mean() < 0.01
    # the bf16 rounding is really applied: exact mode gives other distances
    exact_d, _ = cuda_scan.binned_scan(xt, yt, metric, tile_c=256, exact=True)
    assert float((exact_d.numpy() - got_d)[np.isfinite(got_d)].max()) > 1e-4


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("metric", [Metric.COSINE, Metric.EUCLIDEAN, Metric.DOT],
                         ids=lambda m: m.value)
def test_plain_folded_matches_pallas_with_padded_slots(metric, exact):
    """6 tiles of 256 fold into n_slots=4 x n_jj=2: the last slot is all
    padding and stays +inf; finite slots agree in distance and column."""
    x, y = _unit(16, 8, 7), _unit(1500, 8, 8)
    dtype = jnp.float32 if exact else jnp.bfloat16
    want_d, want_c = pallas_folded_scan(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), metric.value, tile_q=8, tile_c=256,
        n_slots=4, interpret=True, exact=exact,
    )
    want_d, want_c = np.asarray(want_d), np.asarray(want_c)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for fn in (cuda_scan.plain_folded_scan, cuda_scan.folded_scan):
        got_d, got_c = fn(xt, yt, metric, tile_c=256, n_slots=4, exact=exact)
        got_d, got_c = got_d.numpy(), got_c.numpy()
        assert got_d.shape == (16, 4 * LANES)
        fin = np.isfinite(want_d)
        np.testing.assert_array_equal(np.isfinite(got_d), fin)
        assert not fin[:, 3 * LANES :].any() and fin[:, : 2 * LANES].all()
        np.testing.assert_allclose(got_d[fin], want_d[fin], atol=ATOL)
        if exact:
            np.testing.assert_array_equal(got_c[fin], want_c[fin])
        else:
            assert (got_c[fin] != want_c[fin]).mean() < 0.01


def test_plain_folded_true_neighbors_survive():
    """Every query's true nearest neighbor appears in its folded slab (it is
    the minimum of whatever slot its column folds into)."""
    x, y = _unit(24, 16, 9), _unit(3000, 16, 10)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    gt = pairwise_distance(xt, yt, Metric.EUCLIDEAN).argmin(dim=-1).numpy()
    _, cols = cuda_scan.folded_scan(xt, yt, Metric.EUCLIDEAN, tile_c=256, n_slots=8, exact=True)
    want_c = np.asarray(pallas_folded_scan(
        jnp.asarray(x), jnp.asarray(y), "euclidean", tile_q=8, tile_c=256, n_slots=8,
        interpret=True, exact=True,
    )[1])
    assert all(gt[i] in cols[i].numpy() for i in range(24))
    np.testing.assert_array_equal(cols.numpy(), want_c)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_ties_take_the_first_index(exact):
    """Duplicated corpus rows tie exactly: within a tile the first group
    wins, across the tiles of a slot the earliest tile wins."""
    base = _unit(128, 8, 11)
    y = np.concatenate([base] * 8)  # 1024 rows: class l holds row l eight times
    x = _unit(6, 8, 12)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    lane = np.arange(LANES)
    for metric in (Metric.NORMALIZED_COSINE, Metric.SQUARED_EUCLIDEAN):
        _, cols = cuda_scan.binned_scan(xt, yt, metric, tile_c=256, exact=exact)
        want = (np.arange(4) * 256)[:, None] + lane  # first group of each of 4 tiles
        np.testing.assert_array_equal(cols.numpy(), np.tile(want.reshape(-1), (6, 1)))
        _, cols = cuda_scan.folded_scan(xt, yt, metric, tile_c=256, n_slots=2, exact=exact)
        want = (np.arange(2) * 512)[:, None] + lane  # first tile of each of 2 slots
        np.testing.assert_array_equal(cols.numpy(), np.tile(want.reshape(-1), (6, 1)))
    first = cuda_scan._first_min(torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0]]), dim=1)
    assert first[0].item() == 1.0 and first[1].item() == 1


def test_plain_scan_walks_the_corpus_in_passes(monkeypatch):
    """A byte bound that forces one tile per pass gives the same bins."""
    x, y = torch.from_numpy(_unit(9, 8, 13)), torch.from_numpy(_unit(1100, 8, 14))
    want = cuda_scan.plain_binned_scan(x, y, Metric.EUCLIDEAN, tile_c=256, exact=True)
    monkeypatch.setattr(cuda_scan, "MATRIX_BYTE_BUDGET", 1)
    got = cuda_scan.plain_binned_scan(x, y, Metric.EUCLIDEAN, tile_c=256, exact=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fold_shape_and_argument_checks():
    assert cuda_scan.fold_shape(1500, 256, 4) == (4, 2)
    assert cuda_scan.fold_shape(2_097_152, 4096, 32) == (32, 16)
    assert cuda_scan.fold_shape(300, 256, 16) == (2, 1)  # never more slots than tiles
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_scan.binned_scan(x, x, Metric.DOT, tile_c=200)
    with pytest.raises(ValueError, match="int32"):
        cuda_scan._check_tile(2**31 - 100, 4096, -(-(2**31 - 100) // 4096))
    with pytest.raises(TypeError, match="float32"):
        cuda_scan.binned_scan(x.double(), x.double(), Metric.DOT, tile_c=256, exact=True)


def test_cuda_wrappers_reject_cpu_tensors_and_dispatch_rejects_other_devices():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.cuda_binned_scan(x, x, Metric.COSINE, tile_c=256)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.cuda_folded_scan(x, x, Metric.COSINE, tile_c=256)
    m = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no binned-scan path"):
        cuda_scan.binned_scan(m, m, Metric.COSINE, tile_c=256)
    with pytest.raises(ValueError, match="no folded-scan path"):
        cuda_scan.folded_scan(m, m, Metric.COSINE, tile_c=256)
    assert cuda_scan.LAUNCHES == {"binned": 0, "folded": 0}
