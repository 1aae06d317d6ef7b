"""Build and load the port's CUDA kernels (``pointcloududa_torch/csrc/*.cu``).

The sources are compiled by one ``nvcc -shared`` call into one shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers are
compiled, so a build takes seconds. The library is built at first use into
``build/pointcloududa_torch/`` at the repository root (git-ignored), under a
name keyed on a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. A failed build raises; nothing falls back.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero status into an error.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pointcloududa_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--threads", "0",  # nvcc compiles the sources side by side, one thread each
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argument types; every one returns a cudaError_t as int
SIGNATURES = {
    "pcuda_chamfer_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pcuda_chamfer_nn": (_P, _P, _P, _P, _I, _I, _I, _P),
    "pcuda_chamfer_side_grad": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pcuda_bn_stats_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pcuda_bn_stats_backward": (_P, _P, _P, _P, _I, _I, _I, _P),
    "pcuda_fps": (_P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "pcuda_fps_configure": (_P,),
    "pcuda_empty_launch": (_P,),
    "pcuda_max_active_clusters": (_I, _P),
}

MAX_CLUSTER = 8  # blocks in a thread-block cluster at most (the portable maximum)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the build this process ran (ptxas usage)
_active_clusters: dict[tuple[int, int], int] = {}  # (device index, cluster size) -> clusters running at once


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpcuda_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a library for this exact source set exists;
    returns its path. Concurrent builders serialise on a lock file."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in sources() if s.endswith(".cu")]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pcuda_error_string.argtypes = (ctypes.c_int,)
            lib.pcuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        msg = load().pcuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def max_active_clusters(cluster: int, device: torch.device) -> int:
    """How many clusters of ``cluster`` blocks ``device`` runs at once when
    every block takes a whole SM (``csrc/device.cu`` asks the occupancy
    calculator about a block of 1024 threads with all the shared memory a
    block may have). A cluster lies inside one GPC, so fewer clusters of 8
    fit than the SM count suggests."""
    key = (torch.cuda.current_device() if device.index is None else device.index, cluster)
    if key not in _active_clusters:
        clusters = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            check(load().pcuda_max_active_clusters(cluster, ctypes.byref(clusters)), "pcuda_max_active_clusters")
        _active_clusters[key] = clusters.value
    return _active_clusters[key]


def cluster_size(b: int, device: torch.device) -> int:
    """Blocks per item for a kernel that shares each of ``b`` items among a
    cluster: the largest cluster of which the device runs ``b`` at once with
    one block to an SM, so that no item waits for a second wave; one block per
    item when the batch exceeds even that. The first call per device and size
    queries the device and must happen outside a CUDA-graph capture."""
    return max((c for c in range(1, MAX_CLUSTER + 1) if max_active_clusters(c, device) >= b), default=1)
