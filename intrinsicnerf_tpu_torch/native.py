"""ctypes binding to the first-party host C++ (``native/intrinsic_native.cpp``).

The port's own copy of the mean-shift part of ``intrinsicnerf_tpu/native.py``:
the flat-kernel mean-shift sweep and the k-th-neighbour bandwidth
estimate, both OpenMP-parallel.  The library is built with g++ at first
use into ``intrinsicnerf_tpu_torch/_build/libintrinsic_native-<hash>.so``
(keyed by the source's content), never over the JAX package's
``native/libintrinsic_native.so``: the two packages must not rebuild one
file under each other.  This is host code, not a device kernel; without a
toolchain :mod:`intrinsicnerf_tpu_torch.cluster.meanshift` takes its numpy
path and says so.  The mesh entry points (marching tetrahedra, component
filter) come with the port's ``geometry/mesh.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "native", "intrinsic_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libintrinsic_native-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        base = ["g++", *_FLAGS, "-o", tmp, SOURCE]
        try:  # OpenMP parallelises the mean-shift seed loop
            subprocess.run(base + ["-fopenmp"], check=True, capture_output=True, timeout=300)
        except subprocess.CalledProcessError:
            subprocess.run(base, check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (once, with a
    printed reason) when the toolchain cannot build it."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        path = library_path()
        try:
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
            print(f"[native] build/load of {SOURCE} failed, mean-shift uses numpy: {e}")
            return None
        lib.estimate_bandwidth_kth.restype = ctypes.c_double
        lib.estimate_bandwidth_kth.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int64]
        lib.meanshift_iterate.restype = None
        lib.meanshift_iterate.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return load() is not None


def meanshift_iterate(points: np.ndarray, seeds: np.ndarray, bandwidth: float,
                      max_iter: int = 300) -> Tuple[np.ndarray, np.ndarray]:
    """Converge each seed with the flat-kernel mean-shift update; returns
    (converged seeds, support counts)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native meanshift unavailable")
    points = np.ascontiguousarray(points, np.float64)
    seeds = np.ascontiguousarray(seeds, np.float64).copy()
    if points.ndim != 2 or seeds.ndim != 2 or seeds.shape[1] != points.shape[1]:
        raise ValueError(f"points {points.shape} and seeds {seeds.shape} must be [*, D]")
    support = np.empty(len(seeds), np.int64)
    lib.meanshift_iterate(points.ctypes.data, len(points), seeds.ctypes.data, len(seeds),
                          points.shape[1], bandwidth, max_iter, 1e-3 * bandwidth,
                          support.ctypes.data)
    return seeds, support


def estimate_bandwidth_kth(points: np.ndarray, k: int) -> float:
    """Mean distance to the k-th nearest neighbour (self included)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native bandwidth estimator unavailable")
    points = np.ascontiguousarray(points, np.float64)
    if points.ndim != 2:
        raise ValueError(f"points must be [N, D], got {points.shape}")
    return float(lib.estimate_bandwidth_kth(points.ctypes.data, len(points), points.shape[1], k))
