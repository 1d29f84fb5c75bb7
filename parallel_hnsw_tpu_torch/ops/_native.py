"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) through ctypes.

The library is compiled at first use with ``nvcc`` from the package's own
sources into ``parallel_hnsw_tpu_torch/_build/``.  Its file name carries a
hash of the sources and flags, so an edited source rebuilds.  There is no
fallback: a missing ``nvcc`` or a failed build raises.
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
SOURCES = (_PKG / "csrc" / "pairwise_distance.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for src in SOURCES:
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
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see a partial file
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
        _lib = lib
    return _lib
