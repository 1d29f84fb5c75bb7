"""The port's dataset readers (fvecs / bvecs / ivecs over its own native
reader): the cases of tests/test_native_io.py, parity with the JAX package's
readers, and a failed build of the native reader raising."""

import numpy as np
import pytest

from parallel_hnsw_tpu.utils import datasets as jdatasets
from parallel_hnsw_tpu_torch.native import build as native_build
from parallel_hnsw_tpu_torch.utils import datasets


def write_vecs(path, arr, elt):
    n, d = arr.shape
    with open(path, "wb") as f:
        for row in arr:
            np.asarray([d], np.int32).tofile(f)
            if elt == 1:
                row.astype(np.uint8).tofile(f)
            else:
                row.tofile(f)


@pytest.fixture
def fvecs(tmp_path):
    arr = np.random.default_rng(0).normal(size=(100, 24)).astype(np.float32)
    p = tmp_path / "x.fvecs"
    write_vecs(p, arr, 4)
    return str(p), arr


def test_native_compiles():
    from parallel_hnsw_tpu_torch.native import load_vecio

    lib = load_vecio()
    assert lib is not None
    assert native_build.BUILD_DIR.name == "_build"


def test_fvecs_read(fvecs):
    path, arr = fvecs
    out = datasets.read_vecs(path)
    np.testing.assert_allclose(out, arr)


def test_fvecs_slice(fvecs):
    path, arr = fvecs
    out = datasets.read_vecs(path, start=10, count=5)
    np.testing.assert_allclose(out, arr[10:15])


def test_bvecs_read(tmp_path):
    arr = np.random.default_rng(1).integers(0, 256, (50, 8)).astype(np.uint8)
    p = tmp_path / "x.bvecs"
    write_vecs(p, arr, 1)
    out = datasets.read_vecs(str(p))
    np.testing.assert_allclose(out, arr.astype(np.float32))


def test_ivecs_read(tmp_path):
    arr = np.random.default_rng(2).integers(0, 1000, (30, 10)).astype(np.int32)
    p = tmp_path / "gt.ivecs"
    write_vecs(p, arr, 4)
    out = datasets.read_vecs(str(p))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, arr)


def test_native_matches_numpy(fvecs):
    path, arr = fvecs
    nat = datasets.read_vecs(path)
    fallback = datasets._read_vecs_numpy(path, ".fvecs", 4, 0, -1)
    np.testing.assert_array_equal(nat, fallback)


def test_vector_chunks(fvecs):
    path, arr = fvecs
    chunks = list(datasets.vector_chunks(path, chunk_size=30))
    assert [len(c) for c in chunks] == [30, 30, 30, 10]
    np.testing.assert_allclose(np.concatenate(chunks), arr)


# -- parity with the JAX package's readers --------------------------------------

# (extension, rows, width, numpy type written): the threaded read starts at
# 4096 rows, so the fvecs case crosses it
KINDS = [(".fvecs", 5000, 24, np.float32), (".bvecs", 700, 8, np.uint8), (".ivecs", 300, 10, np.int32)]


@pytest.fixture(params=KINDS, ids=[k[0][1:] for k in KINDS])
def vecs_file(request, tmp_path):
    ext, n, d, dtype = request.param
    rng = np.random.default_rng(len(ext) + n)
    if dtype == np.float32:
        arr = rng.normal(size=(n, d)).astype(np.float32)
    else:
        arr = rng.integers(0, 256 if dtype == np.uint8 else 10**6, (n, d)).astype(dtype)
    p = tmp_path / f"x{ext}"
    write_vecs(p, arr, 1 if ext == ".bvecs" else 4)
    return str(p), arr


@pytest.mark.parametrize("start,count", [(0, -1), (0, 7), (3, 250), (250, -1), (299, 5)])
def test_read_vecs_matches_jax(vecs_file, start, count):
    path, arr = vecs_file
    ext = path[path.rindex("."):]
    for threads in (1, 8):
        got = datasets.read_vecs(path, start=start, count=count, n_threads=threads)
        want = jdatasets.read_vecs(path, start=start, count=count, n_threads=threads)
        assert got.dtype == want.dtype == (np.int32 if ext == ".ivecs" else np.float32)
        np.testing.assert_array_equal(got, want)
    stop = len(arr) if count < 0 else min(start + count, len(arr))
    np.testing.assert_array_equal(got, arr[start:stop].astype(got.dtype))
    plain = datasets._read_vecs_numpy(path, ext, 1 if ext == ".bvecs" else 4, start, count)
    np.testing.assert_array_equal(
        plain, jdatasets._read_vecs_numpy(path, ext, 1 if ext == ".bvecs" else 4, start, count))
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("chunk", [64, 299, 4096])
def test_vector_chunks_match_jax(vecs_file, chunk):
    path, _ = vecs_file
    got = list(datasets.vector_chunks(path, chunk_size=chunk))
    want = list(jdatasets.vector_chunks(path, chunk_size=chunk))
    assert [c.shape for c in got] == [c.shape for c in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- a failed build raises ---------------------------------------------------


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler"])
def test_failed_build_raises(fvecs, tmp_path, monkeypatch, cxx):
    """With the library not yet built, a compiler that fails or is missing
    makes the read raise; nothing reads the file another way."""
    monkeypatch.setattr(native_build, "_LIB", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "CXX", cxx)
    with pytest.raises(RuntimeError, match=cxx):
        datasets.read_vecs(fvecs[0])
    assert not list((tmp_path / "build").glob("*.so"))


def test_unreadable_file_raises(tmp_path):
    bad = tmp_path / "bad.fvecs"
    bad.write_bytes(np.asarray([3, 0, 0], np.int32).tobytes())  # a row cut short
    with pytest.raises(IOError):
        datasets.read_vecs(str(bad))
