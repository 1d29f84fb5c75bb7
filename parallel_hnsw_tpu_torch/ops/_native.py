"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) through ctypes.

The library is compiled at first use with ``nvcc`` from the package's own
sources into ``parallel_hnsw_tpu_torch/_build/``: one ``nvcc -c`` per source,
all started together, then one link.  Its file name carries a hash of the
sources and flags, so an edited source rebuilds.  There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (
    _PKG / "csrc" / "pairwise_distance.cu",
    _PKG / "csrc" / "binned_scan.cu",
    _PKG / "csrc" / "row_gather.cu",
    _PKG / "csrc" / "gather_distance.cu",
    _PKG / "csrc" / "queue_merge.cu",
)
#: headers the sources include; part of the library's hash
HEADERS = (_PKG / "csrc" / "bf16_tile.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
#: compiler output of the build this process ran ("" when the library was cached)
build_log = ""


def _nvcc() -> Optional[str]:
    """Path of ``nvcc``, resolved the way PyTorch resolves its CUDA toolkit."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    return shutil.which("nvcc")


def _build() -> Path:
    global build_log
    digest = hashlib.sha256()
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libhnsw_kernels-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in SOURCES]
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objects)
    ]
    outputs = [proc.communicate()[0] for proc in compiles]
    build_log = "".join(outputs)
    failed = [src.name for src, proc in zip(SOURCES, compiles) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    tmp = BUILD_DIR / f"{stem}.tmp"
    link = subprocess.run(
        # -ldl: the tensor maps reach libcuda's encoder through dlopen
        [nvcc, "-shared", "-o", str(tmp), *map(str, objects), "-ldl"],
        capture_output=True, text=True,
    )
    build_log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see a partial file
    for obj in objects:
        obj.unlink()
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        fn = lib.pairwise_distance_f32
        # c_void_p for every pointer and the stream: a plain int would be cut to 32 bits
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        ptr, num = ctypes.c_void_p, ctypes.c_int
        fn = lib.pairwise_distance_bf16
        # x, y (bf16), xn, yn (f32 norms), out; q, c, d, metric; stream
        fn.argtypes = [ptr] * 5 + [num] * 4 + [ptr]
        fn.restype = ctypes.c_int
        fn = lib.bf16_operand_f32
        # m (f32), rows (bf16), norms (f32 or null); n (64-bit), d, d_pad; stream
        fn.argtypes = [ptr] * 3 + [ctypes.c_longlong, num, num, ptr]
        fn.restype = ctypes.c_int
        # x, y, outd, outi[, scratch for the norms: bf16 only]; q, c, d, tile_c,
        # metric; stream
        lib.binned_scan_f32.argtypes = [ptr] * 4 + [num] * 5 + [ptr]
        lib.binned_scan_bf16.argtypes = [ptr] * 5 + [num] * 5 + [ptr]
        # x, y, outt, outi[, scratch]; q, c, d, tile_c, n_slots, n_jj, metric; stream
        lib.folded_scan_f32.argtypes = [ptr] * 4 + [num] * 7 + [ptr]
        lib.folded_scan_bf16.argtypes = [ptr] * 5 + [num] * 7 + [ptr]
        for name in ("binned_scan_f32", "binned_scan_bf16", "folded_scan_f32", "folded_scan_bf16"):
            getattr(lib, name).restype = ctypes.c_int
        fn = lib.row_gather
        # table, idx, out; rows, table_rows, row_bytes (64-bit: rows x row_bytes
        # passes 2^31 when a hop slab is built); stream
        fn.argtypes = [ptr] * 3 + [ctypes.c_longlong] * 3 + [ptr]
        fn.restype = ctypes.c_int
        fn = lib.gather_distance
        # queries, table, idx, out; q, n, k, sub, d, elem_bytes, metric; stream
        fn.argtypes = [ptr] * 4 + [num] * 7 + [ptr]
        fn.restype = ctypes.c_int
        fn = lib.hop_expand
        # queries, table, nodes (or null), neighbors, ids, expanded, frontier,
        # frontier_ok, done, cand_ids, out, evals, counter (or null), all_done
        # (or null); q, n, d, elem_bytes, metric, cap, b, m, n_layer; stream
        fn.argtypes = [ptr] * 14 + [num] * 9 + [ptr]
        fn.restype = ctypes.c_int
        fn = lib.queue_merge
        # ids, dists, flags, cand_ids, cand_dists, done (or null), changed (or
        # null), frontier, frontier_ok, probes (or null), improve_hop,
        # hop_counter (or null); hop_number; all_done (or null); q, cap, c, b;
        # stream
        fn.argtypes = [ptr] * 12 + [num] + [ptr] + [num] * 4 + [ptr]
        fn.restype = ctypes.c_int
        lib.queue_merge_threads.argtypes = [num, num]
        lib.queue_merge_threads.restype = ctypes.c_int
        _lib = lib
    return _lib
