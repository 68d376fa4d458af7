"""ctypes binding to the native C++ PLOC builder (``csrc/ploc.cpp``).

Counterpart of ``bevyray_tpu/bvh/native.py``. ``ensure_built()`` compiles
this package's own copy of the source with plain g++ at first use, into
``build/ploc/`` at the repository root, under a name that carries a hash of
the source (a changed source builds anew; the library is written under a
temporary name and renamed, so processes that build at once never load a
half-written file). If the toolchain or the library is unavailable,
``build_ploc_native`` returns None and the caller falls back to the NumPy
builder, as in the JAX package; :data:`.build.last_builder` records which
of the two ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "ploc.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ploc"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LOCK = threading.Lock()
_TRIED = False


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha1(_SRC.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libploc-{digest}.so"


def ensure_built() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native builder; None on any failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.ploc_build.restype = ctypes.c_int
            lib.ploc_build.argtypes = [
                ctypes.c_int,                     # n leaves
                ctypes.POINTER(ctypes.c_float),   # bmin [n,3]
                ctypes.POINTER(ctypes.c_float),   # bmax [n,3]
                ctypes.c_int,                     # search radius
                ctypes.POINTER(ctypes.c_float),   # out node_min [2n-1,3]
                ctypes.POINTER(ctypes.c_float),   # out node_max [2n-1,3]
                ctypes.POINTER(ctypes.c_int),     # out left
                ctypes.POINTER(ctypes.c_int),     # out right
                ctypes.POINTER(ctypes.c_int),     # out prim
            ]
            _LIB = lib
        except (OSError, subprocess.SubprocessError):
            _LIB = None
        return _LIB


def build_ploc_native(bmin: np.ndarray, bmax: np.ndarray, search_radius: int):
    """Run the C++ PLOC build; the same tuple as ``build_ploc_np``, or None."""
    lib = ensure_built()
    if lib is None:
        return None
    n = bmin.shape[0]
    if n == 0:
        return None
    m = 2 * n - 1
    bmin = np.ascontiguousarray(bmin, np.float32).reshape(n, 3)
    bmax = np.ascontiguousarray(bmax, np.float32).reshape(n, 3)
    node_min = np.zeros((m, 3), np.float32)
    node_max = np.zeros((m, 3), np.float32)
    left = np.zeros(m, np.int32)
    right = np.zeros(m, np.int32)
    prim = np.zeros(m, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    root = lib.ploc_build(
        n, bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp), search_radius,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        left.ctypes.data_as(ip), right.ctypes.data_as(ip),
        prim.ctypes.data_as(ip))
    if root < 0:
        return None
    return node_min, node_max, left, right, prim, int(root)
