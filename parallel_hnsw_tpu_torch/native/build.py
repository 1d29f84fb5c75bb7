"""Build and load the native vector reader (``vecio.cpp``) through ctypes.

The library is compiled at first use with ``g++`` from the package's own
source into ``parallel_hnsw_tpu_torch/_build/`` (as the CUDA kernels are,
``ops/_native.py``); its file name carries a hash of the source and flags,
so an edited source rebuilds.  A missing compiler or a failed build raises:
nothing switches to another reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "vecio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join((CXX,) + CXX_FLAGS).encode())
    lib_path = BUILD_DIR / f"libvecio-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the native vector reader is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib_path.stem}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed on {_SRC.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    return lib_path


def load_vecio() -> ctypes.CDLL:
    """The native IO library, built on first call, with its signatures bound."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.vecio_open.restype = ptr
        lib.vecio_open.argtypes = [ctypes.c_char_p, i32]
        lib.vecio_count.restype = i64
        lib.vecio_count.argtypes = [ptr]
        lib.vecio_dim.restype = i32
        lib.vecio_dim.argtypes = [ptr]
        lib.vecio_close.argtypes = [ptr]
        # file, start row, rows, out, threads
        lib.vecio_read_f32.restype = ctypes.c_int
        lib.vecio_read_f32.argtypes = [ptr, i64, i64, ctypes.POINTER(ctypes.c_float), i32]
        lib.vecio_read_i32.restype = ctypes.c_int
        lib.vecio_read_i32.argtypes = [ptr, i64, i64, ctypes.POINTER(ctypes.c_int32), i32]
        lib.vecio_write_raw_f32.restype = ctypes.c_int
        lib.vecio_write_raw_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), i64, i32]
        _LIB = lib
        return lib
