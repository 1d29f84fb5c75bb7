"""ANN-benchmark dataset readers (fvecs / bvecs / ivecs) over the native mmap
reader (counterpart of ``parallel_hnsw_tpu.utils.datasets``).

A file holds rows of ``[int32 dim][dim elements]``: f32 (``.fvecs``), uint8
(``.bvecs``) or int32 (``.ivecs``).  The readers return numpy arrays, float32
for fvecs and bvecs and int32 for ivecs, as the JAX package's do; the caller
moves them to a device.  Unlike the JAX package, :func:`read_vecs` does not
switch to numpy when the native reader cannot be built: it raises.
:func:`_read_vecs_numpy` is the plain version the tests hold it to.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

from parallel_hnsw_tpu_torch.native import load_vecio


def _kind(path: str):
    """``(extension, bytes per element)`` of a vecs file."""
    ext = os.path.splitext(path)[1].lower()
    return ext, 1 if ext == ".bvecs" else 4


def read_vecs(path: str, start: int = 0, count: int = -1, n_threads: int = 8) -> np.ndarray:
    """Rows ``[start, start + count)`` (``count < 0``: to the end) of an
    fvecs, bvecs or ivecs file, read through the native reader on
    ``n_threads`` threads: float32 ``[n, dim]`` for fvecs / bvecs, int32 for
    ivecs."""
    ext, elt = _kind(path)
    lib = load_vecio()
    vf = lib.vecio_open(os.fsencode(path), elt)
    if not vf:
        raise IOError(f"cannot open {path}")
    try:
        total = lib.vecio_count(vf)
        dim = lib.vecio_dim(vf)
        n = total - start if count < 0 else min(count, total - start)
        if ext == ".ivecs":
            out = np.empty((n, dim), np.int32)
            rc = lib.vecio_read_i32(
                vf, start, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
        else:
            out = np.empty((n, dim), np.float32)
            rc = lib.vecio_read_f32(
                vf, start, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
        if rc != 0:
            raise IOError(f"read failed for {path}")
        return out
    finally:
        lib.vecio_close(vf)


def _read_vecs_numpy(path, ext, elt, start, count):
    """The plain version of :func:`read_vecs`, in numpy."""
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, np.int32, 1)[0])
    row_dtype = np.uint8 if elt == 1 else (np.int32 if ext == ".ivecs" else np.float32)
    stride = 4 + dim * elt
    total = os.path.getsize(path) // stride
    n = total - start if count < 0 else min(count, total - start)
    raw = np.fromfile(path, np.uint8, count=n * stride, offset=start * stride)
    out = raw.reshape(n, stride)[:, 4:].view(row_dtype).reshape(n, dim)
    return out.astype(np.int32 if ext == ".ivecs" else np.float32)


def vector_chunks(path: str, chunk_size: int = 100_000) -> Iterator[np.ndarray]:
    """The file's rows in chunks of ``chunk_size`` (the reference's
    VectorSelector::vector_chunks seam, src/pq.rs:133-137)."""
    _, elt = _kind(path)
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, np.int32, 1)[0])
    total = os.path.getsize(path) // (4 + dim * elt)
    for start in range(0, total, chunk_size):
        yield read_vecs(path, start, min(chunk_size, total - start))
