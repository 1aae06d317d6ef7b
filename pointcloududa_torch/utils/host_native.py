"""Build and load the port's host library (``pointcloududa_torch/csrc/pcuda_host.cpp``):
farthest-point sampling, the boundary voxels of a binary slab and the largest
6-connected component, in C++ on the CPU (the host half of the JAX package's
``utils/native.py``; the source is a byte-for-byte copy of its
``csrc/pcuda_host.cpp``).

The source is compiled by one ``g++ -O3 -fPIC -shared -std=c++17`` call and
loaded with ``ctypes``, at first use, into ``build/pointcloududa_torch/`` at
the repository root (git-ignored), under a name keyed on a hash of the source
and the flags, as ``utils/native.py`` keys the CUDA library. A failed build or
load raises with the compiler's message: nothing falls back to numpy. ctypes
releases the GIL for the duration of a call, so threads overlap their clouds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pcuda_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pointcloududa_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.c_int64
# C entry point -> (return type, argument types)
SIGNATURES = {
    "pcuda_fps": (ctypes.c_int, (_D, _L, _L, _L, _L, _D)),
    "pcuda_boundary_voxels": (ctypes.c_int64, (ctypes.POINTER(ctypes.c_uint8), _L, _L, _L, ctypes.POINTER(ctypes.c_int64), _L)),
    "pcuda_largest_component": (None, (ctypes.POINTER(ctypes.c_int32), _L, _L, _L, ctypes.c_int32,
                                       ctypes.POINTER(ctypes.c_uint8))),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpcuda_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless a library for this exact source exists;
    returns its path. Concurrent builds serialise on a lock file."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library needs it on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build_host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fps(pts: np.ndarray, k: int, start: int) -> np.ndarray:
    """Greedy farthest-point sampling of ``k`` rows of the (n, d) ``pts``
    (n > 0) from row ``start``: float64 squared distances, the first maximum
    on ties; (k, d) float64."""
    lib = load()
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, d = pts.shape
    out = np.zeros((k, d), dtype=np.float64)
    lib.pcuda_fps(_ptr(pts, ctypes.c_double), n, d, k, int(start) % n, _ptr(out, ctypes.c_double))
    return out


def boundary_voxels(slab: np.ndarray) -> np.ndarray:
    """(z, y, x) int64 coordinates of the 6-connected surface voxels of a
    binary 3-D slab, in C order."""
    lib = load()
    slab = np.ascontiguousarray(slab, dtype=np.uint8)
    nz, ny, nx = slab.shape
    cap = int(slab.sum()) + 1
    out = np.zeros((cap, 3), dtype=np.int64)
    n = lib.pcuda_boundary_voxels(_ptr(slab, ctypes.c_uint8), nz, ny, nx, _ptr(out, ctypes.c_int64), cap)
    return out[: min(n, cap)]


def largest_component(mask: np.ndarray, label: int) -> np.ndarray:
    """Binary uint8 mask of the largest 6-connected blob of ``mask == label``
    (2-D or 3-D); of blobs of equal size, the one completed first in C order."""
    lib = load()
    mask = np.ascontiguousarray(mask, dtype=np.int32)
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[np.newaxis]
    nz, ny, nx = mask.shape
    out = np.zeros_like(mask, dtype=np.uint8)
    lib.pcuda_largest_component(_ptr(mask, ctypes.c_int32), nz, ny, nx, int(label), _ptr(out, ctypes.c_uint8))
    return out[0] if squeeze else out
