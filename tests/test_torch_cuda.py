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
from parallel_hnsw_tpu_torch.ops import cuda_distance, cuda_gather, cuda_scan
from parallel_hnsw_tpu_torch.ops.distance import pairwise_distance, pairwise_distance_bf16_dots
from parallel_hnsw_tpu_torch.search import search as graph_search

pytestmark = pytest.mark.cuda

# (Q, C, D, rtol): the JAX kernel test's shapes are held to its atol 2e-5
# alone; at the others the L2 family reaches |x|^2 + |y|^2 ~ 200, where two
# fp32 summation orders differ by a few ulps (1 ulp = 1.5e-5 there), so they
# also get a relative bound of ~8 ulps.
SHAPES = [(70, 130, 32, 0), (1, 3, 7, 0), (64, 128, 16, 1e-6), (129, 67, 100, 1e-6), (300, 1000, 5, 1e-6)]
# Q and C one below, at and above the kernels' 128-row tiles and twice that; D
# across the 8-value partials, the 32- and 64-wide chunks and the 16-byte rows
EDGE_ROWS = [(127, 255), (128, 256), (129, 257), (255, 127), (256, 128), (257, 129)]
EDGE_DIMS = [7, 8, 100, 104, 128, 136]
# The fast mode against ITS plain version (the same bf16-rounded operands, f32
# sums): they differ in the order, and in the tensor cores' rounding, of f32
# sums of exact products -- a handful of ulps of sums that reach ~300 here.
FAST_ATOL, FAST_RTOL = 1e-4, 2e-6


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _pair(q, c, d, device, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(device),
            torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)).to(device))


def _assert_both_modes(x, y, metric, rtol):
    """``exact=True`` against ``pairwise_distance``, ``exact=False`` against
    the bf16-dots plain version; one launch counted per mode."""
    before = dict(cuda_distance.LAUNCHES)
    got = cuda_distance.best_pairwise_distance(x, y, metric, exact=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pairwise_distance(x, y, metric), atol=2e-5, rtol=rtol)
    got = cuda_distance.best_pairwise_distance(x, y, metric, exact=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pairwise_distance_bf16_dots(x, y, metric),
                               atol=FAST_ATOL, rtol=FAST_RTOL)
    assert cuda_distance.LAUNCHES["exact"] == before["exact"] + 1
    assert cuda_distance.LAUNCHES["fast"] == before["fast"] + 1


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_kernel_matches_plain(device, metric):
    for q, c, d, rtol in SHAPES:
        _assert_both_modes(*_pair(q, c, d, device), metric, rtol)


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
@pytest.mark.parametrize("d", EDGE_DIMS)
def test_kernel_matches_plain_across_tile_edges(device, metric, d):
    for q, c in EDGE_ROWS:
        _assert_both_modes(*_pair(q, c, d, device, seed=q + d), metric, 2e-6)


def test_kernel_takes_prepared_operands_and_many_row_tiles(device):
    """Operands prepared once and cut per block give the unprepared call's
    result; and more row tiles than a grid dimension holds (65,535)."""
    x, y = _pair(300, 1000, 100, device)
    for metric in (Metric.EUCLIDEAN, Metric.NORMALIZED_COSINE):
        xo = cuda_distance.prepare_operand(x, metric, exact=False)
        yo = cuda_distance.prepare_operand(y, metric, exact=False)
        assert xo.rows.shape == (300, 104) and xo.rows.dtype == torch.bfloat16
        assert (xo.sq_norms is None) == (metric is Metric.NORMALIZED_COSINE)
        whole = cuda_distance.cuda_pairwise_distance(x, y, metric, exact=False)
        before = dict(cuda_distance.LAUNCHES)
        part = cuda_distance.best_pairwise_distance(xo, yo.narrow(256, 700), metric, exact=False)
        assert torch.equal(part, whole[:, 256:700])
        # a prepared operand serves the exact mode too (its f32 values)
        exact = cuda_distance.best_pairwise_distance(xo, yo.narrow(256, 700), metric, exact=True)
        assert torch.equal(exact, cuda_distance.cuda_pairwise_distance(x, y[256:700], metric))
        assert cuda_distance.LAUNCHES == {"exact": before["exact"] + 2, "fast": before["fast"] + 1,
                                          "operand": before["operand"]}
    no_norms = cuda_distance.prepare_operand(y, Metric.DOT, exact=False)
    with pytest.raises(ValueError):
        cuda_distance.cuda_pairwise_distance(x, no_norms, Metric.EUCLIDEAN, exact=False)
    q = 65_536 * 128 + 5
    x, y = _pair(q, 3, 8, device)
    for exact, plain, atol, rtol in ((True, pairwise_distance, 2e-5, 1e-6),
                                     (False, pairwise_distance_bf16_dots, FAST_ATOL, FAST_RTOL)):
        got = cuda_distance.cuda_pairwise_distance(x, y, Metric.SQUARED_EUCLIDEAN, exact=exact)
        torch.cuda.synchronize()
        for rows in (slice(0, 1000), slice(q - 1000, q)):
            torch.testing.assert_close(got[rows], plain(x[rows], y, Metric.SQUARED_EUCLIDEAN),
                                       atol=atol, rtol=rtol)


# rows too wide for the bf16 kernels' query tile to stay in shared memory
# (it streams through the ring instead): just past the switch, the usual
# embedding widths, and a width that is no multiple of the 64-wide chunks
WIDE_DIMS = [640, 648, 704, 712, 768, 1000, 1536]


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_fast_kernel_takes_wide_rows(device, d):
    """Unit vectors, so the f32 sums of both sides stay within a few ulps of
    values <= 4 whatever D is."""
    x, y = _unit_pair(257, 1281, d, device, seed=d)
    for metric in Metric:
        got = cuda_distance.best_pairwise_distance(x, y, metric, exact=False)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, pairwise_distance_bf16_dots(x, y, metric),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [7, 8, 100, 104, 128, 648])
def test_operand_kernel_matches_plain(device, d):
    """The bf16 rows bit for bit (round to nearest even, zero columns up to a
    multiple of 8); the norms of the unrounded rows within 4 f32 ulps (the
    kernel sums in fp64, ``torch.sum`` in f32)."""
    for n in (1, 31, 4099):
        m = _pair(n, 1, d, device, seed=n + d)[0] * 3.0
        # a 16-byte aligned base, then one that is only 4-byte aligned
        for source in (m, m.reshape(-1)[1 : 1 + (n - 1) * d].view(n - 1, d)):
            if source.shape[0] == 0:
                continue
            before = cuda_distance.LAUNCHES["operand"]
            rows, norms = cuda_distance.cuda_bf16_operand(source, with_norms=True)
            torch.cuda.synchronize()
            assert cuda_distance.LAUNCHES["operand"] == before + 1
            want_rows, want_norms = cuda_distance.plain_bf16_operand(source, with_norms=True)
            assert rows.dtype == torch.bfloat16 and rows.shape == (source.shape[0], d + -d % 8)
            assert rows.data_ptr() % 16 == 0 and torch.equal(rows, want_rows)
            torch.testing.assert_close(norms, want_norms, atol=0, rtol=5e-7)
            assert cuda_distance.cuda_bf16_operand(source)[1] is None
            assert torch.equal(cuda_distance.cuda_bf16_operand(source)[0], want_rows)
    with pytest.raises(TypeError):
        cuda_distance.cuda_bf16_operand(m.double())
    with pytest.raises(ValueError):
        cuda_distance.cuda_bf16_operand(m.T)
    assert cuda_distance.cuda_bf16_operand(m[:0], with_norms=True)[0].shape == (0, d + -d % 8)


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
# Q and C around the scans' 128-row query tile and 128-row corpus groups, D
# across the 16-byte rows and the 64-wide chunks of the bf16 kernel
SCAN_EDGE_SHAPES = [(127, 255, 7, 128, 2), (128, 256, 8, 128, 2), (129, 257, 100, 256, 2),
                    (255, 127, 104, 128, 1), (256, 1280, 128, 256, 3), (257, 1281, 136, 256, 3),
                    (385, 2000, 100, 384, 4)]


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


@pytest.mark.parametrize("shapes", [SCAN_SHAPES, SCAN_EDGE_SHAPES], ids=["jax_and_ragged", "tile_edges"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_scan_kernels_match_plain(device, metric, exact, shapes):
    for q, c, d, tile_c, n_slots in shapes:
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


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_scan_kernels_take_wide_rows(device, d):
    x, y = _unit_pair(257, 3000, d, device, seed=d)
    for metric in (Metric.NORMALIZED_COSINE, Metric.EUCLIDEAN, Metric.DOT):
        got = cuda_scan.binned_scan(x, y, metric, tile_c=512, exact=False)
        torch.cuda.synchronize()
        want = cuda_scan.plain_binned_scan(x, y, metric, tile_c=512, exact=False)
        _assert_bins_agree(got, want, x, y, metric, exact=False)
        got = cuda_scan.folded_scan(x, y, metric, tile_c=256, n_slots=5, exact=False)
        torch.cuda.synchronize()
        want = cuda_scan.plain_folded_scan(x, y, metric, tile_c=256, n_slots=5, exact=False)
        _assert_bins_agree(got, want, x, y, metric, exact=False)


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


# -- the row-gather kernel ------------------------------------------------------

# (dtype, trailing shape): f32 feature rows (16-, 8- and 4-byte vectors), bf16
# routing rows (200-byte rows are only 8-byte aligned, 2-byte rows), int32
# neighbor rows, slab rows
GATHER_TABLES = [
    (torch.float32, (100,)), (torch.float32, (128,)), (torch.float32, (96,)),
    (torch.float32, (1,)), (torch.float32, (7,)), (torch.bfloat16, (64,)),
    (torch.bfloat16, (100,)), (torch.bfloat16, (128,)), (torch.bfloat16, (1,)),
    (torch.bfloat16, (33,)), (torch.int32, (24,)), (torch.int32, (48,)),
    (torch.float32, (48, 100)), (torch.bfloat16, (48, 100)), (torch.uint8, (3,)),
]


def _table(n, dtype, tail, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    t = torch.randint(0, 1 << 15, (n, *tail), generator=gen)
    return (t.to(dtype) if dtype in (torch.int32, torch.uint8) else (t.float() - 16384).to(dtype)).to(device)


@pytest.mark.parametrize("dtype,tail", GATHER_TABLES, ids=lambda v: str(v).replace("torch.", ""))
def test_row_gather_is_bit_identical(device, dtype, tail):
    n = 5000 if len(tail) == 1 else 300
    table = _table(n, dtype, tail, device)
    gen = torch.Generator().manual_seed(1)
    for r in (1, 3, 2047, 2048, 100_000):
        idx = torch.randint(0, n, (r,), generator=gen, dtype=torch.int32)
        idx[: min(r, 4)] = torch.tensor([0, n - 1, 7, 7])[: min(r, 4)]  # ends, a repeat
        idx = idx.to(device)
        before = cuda_gather.LAUNCHES["row_gather"]
        got = cuda_gather.row_gather(table, idx)
        torch.cuda.synchronize()
        assert cuda_gather.LAUNCHES["row_gather"] == before + 1
        assert got.dtype == dtype and got.shape == (r, *tail)
        assert torch.equal(got, cuda_gather.plain_row_gather(table, idx))


def test_row_gather_takes_views_and_unaligned_bases(device):
    base = _table(4001, torch.bfloat16, (100,), device)
    idx2d = torch.randint(0, 4000, (64, 192), dtype=torch.int32).to(device)
    # a table whose base pointer is only 2-byte aligned (rows of 99 bf16)
    odd = base.reshape(-1)[1 : 1 + 4000 * 99].view(4000, 99)
    assert odd.is_contiguous() and odd.data_ptr() % 4 == 2
    for table in (base[1:], odd):
        for idx in (idx2d, idx2d.T, idx2d[:, ::3], idx2d[5]):
            got = cuda_gather.cuda_row_gather(table, idx)
            assert got.shape == (*idx.shape, table.shape[1])
            assert torch.equal(got, table[idx.long()])
    # an output whose rows are wider than 2^31 bytes in all
    wide = _table(50, torch.float32, (48, 100), device)
    idx = torch.randint(0, 50, (120_000,), dtype=torch.int32).to(device)
    got = cuda_gather.cuda_row_gather(wide, idx)
    assert got.numel() * 4 > 2**31
    for s in (0, 60_000, 119_000):
        assert torch.equal(got[s : s + 1000], wide[idx[s : s + 1000].long()])


def test_row_gather_rejects_bad_operands(device):
    table = _table(10, torch.float32, (8,), device)
    idx = torch.zeros(4, dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        cuda_gather.cuda_row_gather(table, idx.long())
    with pytest.raises(ValueError):
        cuda_gather.cuda_row_gather(table, idx.cpu())
    with pytest.raises(ValueError):
        cuda_gather.cuda_row_gather(table.T, idx)
    with pytest.raises(ValueError):
        cuda_gather.cuda_row_gather(table[:, 0], idx)
    with pytest.raises(ValueError):
        cuda_gather.cuda_row_gather(table.cpu(), idx.cpu())
    with pytest.raises(ValueError):
        cuda_gather.cuda_row_gather(table[:0], idx)
    before = cuda_gather.LAUNCHES["row_gather"]
    assert cuda_gather.cuda_row_gather(table, idx[:0]).shape == (0, 8)
    assert cuda_gather.LAUNCHES["row_gather"] == before


# -- the hop's gather-and-distance kernel ------------------------------------------

# Unit rows and queries: the partial sums of a dot or of a squared distance
# stay within [-4, 4], where the kernel's lane-group order and the plain
# version's (a batched product, a torch.sum) differ by a few ulps of 4 (4.8e-7
# each) at D <= 128 and by ~sqrt(D) of them at D = 768.
GATHER_DISTANCE_ATOL = 2e-5
GATHER_DISTANCE_DIMS = [1, 33, 64, 100, 128, 768]


def _hop_operands(q, n, sub, k, d, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    shape = (n, d) if sub == 1 else (n, sub, d)
    table = torch.nn.functional.normalize(torch.randn(shape, generator=gen), dim=-1)
    queries = torch.nn.functional.normalize(torch.randn((q, d), generator=gen), dim=-1)
    idx = torch.randint(0, n, (q, k), generator=gen, dtype=torch.int32)
    idx[0, : min(k, 3)] = torch.tensor([0, n - 1, n - 1], dtype=torch.int32)[: min(k, 3)]
    # indices outside the table bring no row: EMPTY_ID, past the end, negative
    idx[1, : min(k, 3)] = torch.tensor([2**31 - 1, n, -1], dtype=torch.int32)[: min(k, 3)]
    idx[2] = 2**31 - 1  # a query that is done
    return queries.to(device), table.to(dtype).to(device), idx.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", GATHER_DISTANCE_DIMS)
def test_gather_distance_matches_plain(device, d, dtype):
    """K not a multiple of a lane group's rows; a slab of 48 rows an index,
    and more candidate rows than one block takes (13 x 48 > 512)."""
    for sub, n, k in ((1, 3000, 37), (48, 60, 3), (48, 60, 13)):
        queries, table, idx = _hop_operands(300, n, sub, k, d, dtype, device, seed=d + sub + k)
        for metric in Metric:
            before = cuda_gather.LAUNCHES["gather_distance"]
            got = cuda_gather.gather_distance(queries, table, idx, metric)
            torch.cuda.synchronize()
            assert cuda_gather.LAUNCHES["gather_distance"] == before + 1
            assert got.shape == (300, k * sub) and got.dtype == torch.float32
            want = cuda_gather.plain_gather_distance(queries, table, idx, metric)
            torch.testing.assert_close(got, want, atol=GATHER_DISTANCE_ATOL, rtol=0)
            assert bool(torch.isinf(got[2]).all()) and int(torch.isinf(got).sum()) == int(
                torch.isinf(want).sum())
        before = cuda_gather.LAUNCHES["gather_distance"]
        empty = cuda_gather.cuda_gather_distance(queries[:0], table, idx[:0], Metric.DOT)
        assert empty.shape == (0, k * sub) and cuda_gather.LAUNCHES["gather_distance"] == before


def test_gather_distance_does_not_depend_on_the_batch(device):
    """A query's distances are the same bits alone and in a batch; tables
    whose base is only 4- or 2-byte aligned take narrower copies (and so
    another order) and agree within the tolerance."""
    queries, table, idx = _hop_operands(300, 3000, 1, 192, 100, torch.float32, device, seed=1)
    for metric in Metric:
        whole = cuda_gather.cuda_gather_distance(queries, table, idx, metric)
        alone = cuda_gather.cuda_gather_distance(queries[7:8], table, idx[7:8], metric)
        assert torch.equal(whole[7:8], alone)
    for dtype in (torch.float32, torch.bfloat16):
        wide = table.to(dtype).reshape(-1)
        odd = wide[1 : 1 + 2999 * 100].view(2999, 100)
        assert odd.data_ptr() % 8 == wide.element_size()
        for metric in (Metric.NORMALIZED_COSINE, Metric.EUCLIDEAN):
            got = cuda_gather.cuda_gather_distance(queries, odd, idx, metric)
            torch.testing.assert_close(got, cuda_gather.plain_gather_distance(queries, odd, idx, metric),
                                       atol=GATHER_DISTANCE_ATOL, rtol=0)


def test_gather_distance_rejects_bad_operands(device):
    queries, table, idx = _hop_operands(8, 50, 1, 5, 16, torch.float32, device, seed=2)
    with pytest.raises(ValueError):
        cuda_gather.cuda_gather_distance(queries, table.T.contiguous().T, idx, Metric.DOT)
    with pytest.raises(ValueError):
        cuda_gather.cuda_gather_distance(queries.cpu(), table, idx, Metric.DOT)
    with pytest.raises(TypeError):
        cuda_gather.cuda_gather_distance(queries, table, idx.long(), Metric.DOT)
    with pytest.raises(ValueError):
        cuda_gather.cuda_gather_distance(queries, table[:, :8], idx, Metric.DOT)


@pytest.fixture(scope="module")
def small_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (3100, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    vecs = torch.from_numpy(x).to("cuda:0")
    hnsw = Hnsw.generate(DenseSource(vecs[:3000]), metric=Metric.NORMALIZED_COSINE, seed=1)
    return hnsw, vecs[3000:]


def test_search_family_on_device(device, small_index):
    hnsw, queries = small_index
    before = dict(cuda_gather.LAUNCHES)
    ids, dists = hnsw.search(queries)
    # the entry vector by the row gather; the hop's neighbor rows and
    # distances by its expand kernel, not by the gather kernels
    ran = {k: cuda_gather.LAUNCHES[k] - before[k] for k in before}
    assert ran["row_gather"] == 1 and ran["gather_distance"] == 0 and ran["hop_expand"] > 0
    i_ids, i_d, stats = hnsw.search_instrumented(queries)
    assert torch.equal(ids, i_ids) and torch.equal(dists, i_d)
    assert stats["hops"] > 0 and stats["distance_evaluations"] > 0
    assert stats["last_improvement_hop"].shape == (queries.shape[0],)
    # adaptive batches shrink; the hop's distances do not depend on the batch
    a_ids, a_d = graph_search(hnsw.layers, hnsw.compute_source, hnsw.metric, queries,
                              hnsw.build_parameters.optimization.search, adaptive=True)
    assert torch.equal(a_ids, ids) and torch.equal(a_d, dists)
    top, _ = hnsw.search_upto(queries, None, 1)
    assert top.shape == ids.shape
    with pytest.raises(ValueError):
        hnsw.search_upto(queries, None, 0)


def test_slabs_and_routing_on_device(device, small_index):
    hnsw, queries = small_index
    gt, _ = hnsw.search_exact(queries, k=10)
    ids, dists = hnsw.search(queries)

    def recall(found):
        return float((found[:, :10, None] == gt[:, None, :]).any(-1).float().mean())

    hnsw.enable_hop_slabs()
    assert not hnsw._hop_slabs.routed and hnsw._hop_slabs.slabs[-1].shape == (3000, 48, 32)
    s_ids, s_d = hnsw.search(queries)
    assert torch.equal(ids, s_ids) and torch.equal(dists, s_d)
    hnsw.disable_hop_slabs()
    hnsw.enable_routing(dr=None)
    assert hnsw._routing.rows.dtype == torch.bfloat16 and hnsw._routing.rows.is_cuda
    r_ids, r_d = hnsw.search(queries)
    assert recall(r_ids) >= recall(ids) - 0.02
    assert bool(torch.isfinite(r_d[:, :10]).all()) and bool((r_d[:, 1:] >= r_d[:, :-1]).all())
    hnsw.enable_hop_slabs()
    assert hnsw._hop_slabs.routed and hnsw._hop_slabs.slabs[-1].dtype == torch.bfloat16
    rs_ids, rs_d = hnsw.search(queries)
    assert torch.equal(r_ids, rs_ids) and torch.equal(r_d, rs_d)
    f_ids, _ = hnsw.search(queries, routed=False)
    assert torch.equal(f_ids, ids)
    hnsw.disable_hop_slabs()
    hnsw.enable_routing(dr=16, seed=3)
    assert hnsw._routing.rows.shape == (3000, 16)
    self_ids, _ = hnsw.search(hnsw.source.vectors[:64])
    assert bool((self_ids[:, 0] == torch.arange(64, device=device)).all())
    hnsw.disable_routing()
    hnsw.enable_hop_slabs()
    hnsw.improve_neighbors()
    assert hnsw._hop_slabs is None


def test_selfsim_and_resume_on_device(device, small_index, tmp_path):
    hnsw, _ = small_index
    vec_ids, nn_ids, nn_d = hnsw.knn(5)
    assert nn_ids.shape == (3000, 5) and not (nn_ids == vec_ids[:, None]).any()
    assert (np.diff(nn_d, axis=1) >= 0).all()
    full = pairwise_distance(hnsw.source.vectors, hnsw.source.vectors, Metric.NORMALIZED_COSINE)
    full.fill_diagonal_(float("inf"))
    want = torch.sort(full, dim=-1).values[:, 0].cpu().numpy()
    assert np.mean(np.abs(nn_d[:, 0] - want) <= 1e-6) >= 0.98
    _, t_ids, t_d = hnsw.threshold_nn(0.2)
    inside = t_ids != np.iinfo(np.int32).max
    assert (t_d[inside] < 0.2).all() and np.isinf(t_d[~inside]).all()
    bp = BuildParams()
    source = DenseSource(hnsw.source.vectors[:1200])
    first = Hnsw.generate(source, bp=bp, metric=Metric.NORMALIZED_COSINE, seed=4,
                          checkpoint_dir=str(tmp_path / "ckpt"))
    again = Hnsw.generate(source, bp=bp, metric=Metric.NORMALIZED_COSINE, seed=4,
                          checkpoint_dir=str(tmp_path / "ckpt"))
    assert again.layers[0].nodes.is_cuda
    for a, b in zip(first.layers, again.layers):
        assert torch.equal(a.nodes, b.nodes)


# -- product quantization on the card ----------------------------------------


@pytest.mark.parametrize("c", [4096, 65_535])
@pytest.mark.parametrize("d", [4, 8, 16, 96])
def test_binned_scan_at_pq_widths(device, d, c):
    """The fast binned scan at sub-vector widths (D = 4 is padded to 8) over
    a codebook of 4096 or 65,535 rows (a partial last tile), tile_c 4096 as
    the quantize route calls it; and at D = 96, the per-subspace index's flat
    scan over its decoded codes."""
    x, y = _unit_pair(300, c, d, device, seed=d)
    for metric in (Metric.SQUARED_EUCLIDEAN, Metric.EUCLIDEAN, Metric.NORMALIZED_COSINE):
        got = cuda_scan.binned_scan(x, y, metric, tile_c=4096, exact=False)
        torch.cuda.synchronize()
        want = cuda_scan.plain_binned_scan(x, y, metric, tile_c=4096, exact=False)
        assert got[0].shape == (300, -(-c // 4096) * 128)
        _assert_bins_agree(got, want, x, y, metric, exact=False)


def test_gather_distance_at_pq_width(device):
    """D = 1536, the code graph's hop on densified codes.  Unit rows: two
    summation orders of 1536 terms whose partial sums stay within [0, 4]
    differ by ~sqrt(1536) ulps of 4 (1.9e-5), so 4e-5."""
    queries, table, idx = _hop_operands(227, 5000, 1, 192, 1536, torch.float32, device, seed=9)
    for metric in Metric:
        got = cuda_gather.gather_distance(queries, table, idx, metric)
        torch.cuda.synchronize()
        want = cuda_gather.plain_gather_distance(queries, table, idx, metric)
        torch.testing.assert_close(got, want, atol=4e-5, rtol=0)


def test_exact_kernel_at_pq_width(device):
    """D = 1536, the code graph's exact seeds and relinks on densified codes
    (the fast mode at this width is in test_fast_kernel_takes_wide_rows).
    Unit rows, the diagonal included: within ~sqrt(1536) ulps of 4 (4e-5, as
    the hop above).  Euclidean is left out: at distance 0 its root turns an
    ulp of the square into ~5e-4."""
    x, y = _unit_pair(300, 2000, 1536, device, seed=12)
    y[:300] = x
    for metric in (m for m in Metric if m is not Metric.EUCLIDEAN):
        got = cuda_distance.cuda_pairwise_distance(x, y, metric, exact=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, pairwise_distance(x, y, metric), atol=4e-5, rtol=0)


def test_quantize_binned_matches_the_exact_argmin(device):
    from parallel_hnsw_tpu_torch.pq import quantize_binned

    rng = np.random.default_rng(9)
    subs = torch.from_numpy(rng.normal(size=(20_000, 16)).astype(np.float32)).to(device)
    cents = torch.from_numpy(rng.normal(size=(65_535, 16)).astype(np.float32)).to(device)
    before = dict(cuda_scan.LAUNCHES)
    fast = quantize_binned(subs, cents, Metric.EUCLIDEAN, block=8192)
    assert cuda_scan.LAUNCHES["binned"] == before["binned"] + 3
    exact = analysis.blocked_topk_pairwise(subs, cents, Metric.EUCLIDEAN, 1)[0][:, 0]
    assert fast.dtype == torch.int32 and float((fast == exact).float().mean()) >= 0.999


def test_uint16_codes_reconstruct_through_the_card(device):
    """uint16 codes (through 65,535) reconstruct on the card, through the row
    gather kernel, as on the CPU, for both codebook kinds."""
    from parallel_hnsw_tpu_torch.graph import PqSource, narrow_codes, reconstruct, source_get

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 65_536, (3000, 12)).astype(np.int32)
    codes[0] = 65_535
    codes16 = narrow_codes(torch.from_numpy(codes))
    assert codes16.dtype == torch.uint16
    on_card = codes16.view(torch.int16).to(device).view(torch.uint16)
    for book in (rng.normal(size=(65_536, 4)), rng.normal(size=(12, 65_536, 2))):
        book = torch.from_numpy(book.astype(np.float32))
        want = reconstruct(book, codes16)
        before = cuda_gather.LAUNCHES["row_gather"]
        got = reconstruct(book.to(device), on_card)
        assert cuda_gather.LAUNCHES["row_gather"] == before + 1
        assert torch.equal(got.cpu(), want)
        src = PqSource(codes=on_card, codebook=book.to(device))
        ids = torch.tensor([0, 2999, 7, 7, -5, 1 << 30], dtype=torch.int32)
        assert torch.equal(source_get(src, ids.to(device)).cpu(),
                           source_get(PqSource(codes16, book), ids))


def test_quantized_index_on_device(device, tmp_path):
    """A small QuantizedHnsw on the card: both quantizer kinds build, search
    (code graph and flat scan), and come back from disk onto the card."""
    from parallel_hnsw_tpu_torch import (
        PqBuildParams,
        QuantizedHnsw,
        deserialize_quantized_hnsw,
        serialize_quantized_hnsw,
    )

    rng = np.random.default_rng(2)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    source = DenseSource(torch.from_numpy(x).to(device))
    for kw in ({"fast_quantize": True}, {"per_subspace": True, "use_kmeans": True}):
        q = QuantizedHnsw.new(256, source, 4, Metric.EUCLIDEAN, pqp=PqBuildParams(), seed=0, **kw)
        assert q.hnsw.source.codes.dtype == torch.uint16 and q.hnsw.source.codes.is_cuda
        ids, _ = q.search(source.vectors[:500], exact_quantize=True)
        assert float((ids[:, 0] == torch.arange(500, device=device)).float().mean()) >= 0.95
        f_ids, _ = q.search_exact(source.vectors[:500], k=10)
        assert float((f_ids[:, 0] == torch.arange(500, device=device)).float().mean()) >= 0.99
        serialize_quantized_hnsw(q, tmp_path / str(len(kw)))
        loaded = deserialize_quantized_hnsw(tmp_path / str(len(kw)))
        assert loaded.hnsw.source.codes.is_cuda
        assert torch.equal(loaded.search(source.vectors[:100])[0], q.search(source.vectors[:100])[0])


# ---------------------------------------------------------------------------
# out-of-core sources and the sharded indexes


def test_host_rerank_onto_the_card(device, tmp_path):
    """exact_rerank over a memmap gathers candidate rows on the host and moves
    them to the queries' device: the card's answer against the CPU's."""
    from parallel_hnsw_tpu_torch.graph import open_memmap_source
    from parallel_hnsw_tpu_torch.routing import exact_rerank

    rng = np.random.default_rng(7)
    arr = rng.normal(size=(5000, 96)).astype(np.float32)
    arr.tofile(tmp_path / "corpus.f32")
    mm = open_memmap_source(str(tmp_path / "corpus.f32"), 96)
    ids = torch.from_numpy(rng.integers(0, 5000, (300, 40)).astype(np.int32))
    ids[:, -3:] = -1
    q = torch.from_numpy(rng.normal(size=(300, 96)).astype(np.float32))
    for metric in (Metric.EUCLIDEAN, Metric.NORMALIZED_COSINE):
        got_i, got_d = exact_rerank(mm, metric, q.to(device), ids.to(device))
        want_i, want_d = exact_rerank(mm, metric, q, ids)
        assert got_i.is_cuda and got_d.is_cuda
        torch.testing.assert_close(got_d.cpu(), want_d, atol=2e-5, rtol=1e-6)
        fin = torch.isfinite(want_d)
        assert float((got_i.cpu() == want_i)[fin].float().mean()) >= 0.999


@pytest.mark.parametrize("n, fast", [(1000, False), (1000, True), (210_000, True)],
                         ids=["exact", "fast-pairwise", "fast-binned"])
def test_shard_flat_scan_on_the_card(device, n, fast):
    """One shard's flat scan (dense and PQ rows) on CUDA tensors against the
    CPU plain versions: the same survivors by value (fast: the bf16 scan
    rounds differently from the CPU's fp32, so the ids as sets at equal
    distance, most of them), each through its kernel."""
    from parallel_hnsw_tpu_torch.graph import PqSource
    from parallel_hnsw_tpu_torch.parallel.sharded import _shard_flat_scan

    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = torch.from_numpy(x[:64] + 0.01)
    book = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (n, 4)).astype(np.int32))
    for local in (DenseSource(torch.from_numpy(x)), PqSource(codes=codes, codebook=book)):
        card = type(local)(*(t.to(device) for t in local))
        before = dict(cuda_scan.LAUNCHES), dict(cuda_distance.LAUNCHES)
        got_i, got_d = _shard_flat_scan(card, q.to(device), Metric.NORMALIZED_COSINE, 40, fast)
        want_i, want_d = _shard_flat_scan(local, q, Metric.NORMALIZED_COSINE, 40, fast)
        if n >= 200_000:
            assert cuda_scan.LAUNCHES["binned"] > before[0]["binned"]
        else:
            key = "fast" if fast else "exact"
            assert cuda_distance.LAUNCHES[key] > before[1][key]
        if not fast:
            assert torch.equal(got_i.cpu(), want_i)
            torch.testing.assert_close(got_d.cpu(), want_d, atol=2e-5, rtol=0)
        else:
            same = np.mean([len(set(a) & set(b)) / 40 for a, b in
                            zip(got_i.cpu().numpy(), want_i.numpy())])
            assert same >= 0.9, same


def test_sharded_indexes_on_the_card(device, tmp_path):
    """4 shards on one card: the dense index and the out-of-core PQ index
    build, search on the card, and agree with their CPU twins."""
    from parallel_hnsw_tpu_torch.graph import open_memmap_source
    from parallel_hnsw_tpu_torch.parallel import Mesh, ShardedHnsw, ShardedQuantizedHnsw

    rng = np.random.default_rng(9)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    mesh = Mesh([device] * 4)
    sh = ShardedHnsw.generate(DenseSource(torch.from_numpy(x).to(device)), mesh,
                              metric=Metric.NORMALIZED_COSINE, seed=0)
    q = torch.from_numpy(x[:500]).to(device)
    ids, _ = sh.search(q, k=10)
    assert ids.is_cuda and float((ids[:, 0] == torch.arange(500, device=device)).float().mean()) >= 0.95
    e_ids, _ = sh.search_exact(q, k=10, fast=True)
    assert float((e_ids[:, 0] == torch.arange(500, device=device)).float().mean()) == 1.0
    assert sh.stochastic_recall() >= 0.95

    x.tofile(tmp_path / "corpus.f32")
    mm = open_memmap_source(str(tmp_path / "corpus.f32"), 32)
    sq = ShardedQuantizedHnsw.new(1024, mm, 4, Metric.EUCLIDEAN, mesh, fast_quantize=True,
                                  build_graphs=False)
    cpu = ShardedQuantizedHnsw.new(1024, mm, 4, Metric.EUCLIDEAN, Mesh(["cpu"] * 4),
                                   exact_quantize=True, build_graphs=False)
    assert sq.sharded.shard_source(0).codes.is_cuda
    agree = (sq.sharded.source_stacked.codes.view(torch.int16).cpu()
             == cpu.sharded.source_stacked.codes.view(torch.int16)).float().mean()
    assert float(agree) >= 0.999
    p_ids, p_d = sq.search_exact(q, k=10)
    assert float((p_ids[:, 0] == torch.arange(500, device=device)).float().mean()) >= 0.99
    assert float(p_d[:, 0].abs().max()) < 1e-3


# -- the graph diagnostics, a source of the user's and the dataset reader -----


def _cut_layer(n, m, device, seed=4):
    """A random layer of ``n`` nodes (vector ids 0, 2, 4, ...) and ``m``
    slots, with ``EMPTY_ID`` slots, a repeated neighbor and a few nodes that
    no edge reaches."""
    from parallel_hnsw_tpu_torch.constants import EMPTY_ID
    from parallel_hnsw_tpu_torch.graph import make_layer

    rng = np.random.default_rng(seed)
    nb = rng.integers(0, n, (n, m)).astype(np.int32)
    nb[rng.random((n, m)) < 0.1] = EMPTY_ID
    nb[:, 1] = nb[:, 0]
    nb[np.isin(nb, [3, 4, 5])] = EMPTY_ID
    return make_layer(np.arange(0, 2 * n, 2), nb, device=device)


def test_node_distances_on_the_card(device):
    """The BFS fixpoints on the card equal the CPU run of the same code."""
    layer = _cut_layer(20_000, 16, device)
    cpu = type(layer)(layer.nodes.cpu(), layer.neighbors.cpu())
    # vector ids of nodes, one outside the layer (odd), nodes 3-5 excluded
    supers = np.array([0, 14, 200, 7_000, 39_998, 1], np.int32)
    got = analysis.node_distances(layer, torch.from_numpy(supers).to(device))
    want = analysis.node_distances(cpu, supers)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == np.iinfo(np.int32).max).sum() >= 3
    np.testing.assert_array_equal(analysis.discover_nodes_to_promote(layer, supers),
                                  analysis.discover_nodes_to_promote(cpu, supers))
    many = np.arange(0, 4000, 22, dtype=np.int32)  # 182 supers: three chunks of 64
    for g, w in zip(analysis.per_super_node_distances(layer, many),
                    analysis.per_super_node_distances(cpu, many)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(analysis.multi_node_distances(layer, many), analysis.multi_node_distances(cpu, many)):
        np.testing.assert_array_equal(g, w)


class _ScaledSource:
    """A storage type of the user's, registered with ``source_get`` alone."""

    def __init__(self, vectors, scale):
        self.vectors, self.scale = vectors, scale
        self.dim, self.count, self.device = vectors.shape[1], vectors.shape[0], vectors.device


def _register_scaled_source():
    from parallel_hnsw_tpu_torch.graph import source_get

    @source_get.register
    def _(source: _ScaledSource, ids):
        safe = torch.clamp(ids, 0, source.count - 1)
        return source.vectors[safe.long()] * source.scale


def test_custom_source_on_the_card(device):
    """A source of the user's builds and searches on the card.  Over small
    integers under squared euclidean every distance is exact, so its index
    equals the dense source's on the card (same draws), and each row finds
    itself first on the card and on the CPU."""
    _register_scaled_source()
    grid = np.random.default_rng(23).integers(-4, 5, size=(600, 16)).astype(np.float32)
    rows = torch.from_numpy(grid)
    indexes = []
    for where in (device, torch.device("cpu")):
        src = _ScaledSource(rows.to(where), 1.0)
        h = Hnsw.generate(src, metric=Metric.SQUARED_EUCLIDEAN, seed=3)
        ids, _ = h.search(src.vectors)
        assert ids.device.type == where.type
        np.testing.assert_array_equal(ids[:, 0].cpu().numpy(), np.arange(600))
        indexes.append(h)
    dense = Hnsw.generate(DenseSource(rows.to(device)), metric=Metric.SQUARED_EUCLIDEAN, seed=3)
    for a, b in zip(indexes[0].layers, dense.layers):
        assert torch.equal(a.nodes, b.nodes) and torch.equal(a.neighbors, b.neighbors)


def test_read_vecs_into_a_card_build(device, tmp_path):
    """Rows read from an fvecs file build on the card the index that the same
    rows, drawn, build there."""
    from parallel_hnsw_tpu_torch.utils.datasets import read_vecs

    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (3000, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    buf = np.empty((3000, 25), np.int32)
    buf[:, 0] = 24
    buf[:, 1:] = x.view(np.int32)
    buf.tofile(tmp_path / "x.fvecs")
    read = read_vecs(str(tmp_path / "x.fvecs"))
    assert read.dtype == np.float32 and np.array_equal(read.view(np.int32), x.view(np.int32))
    built = [Hnsw.generate(DenseSource(torch.from_numpy(r).to(device)),
                           metric=Metric.NORMALIZED_COSINE, seed=1) for r in (read, x)]
    for a, b in zip(*(h.layers for h in built)):
        assert torch.equal(a.nodes, b.nodes) and torch.equal(a.neighbors, b.neighbors)
    q = torch.from_numpy(read[:200]).to(device)
    ids, _ = built[0].search(q)
    assert ids.device == q.device and float((ids[:, 0] == torch.arange(200, device=device)).float().mean()) >= 0.99
