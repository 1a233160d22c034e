"""ctypes binding to the first-party host C++ (``native/intrinsic_native.cpp``).

The port's own copy of ``intrinsicnerf_tpu/native.py``: the flat-kernel
mean-shift sweep and the k-th-neighbour bandwidth estimate, both
OpenMP-parallel, and the mesh tools of ``geometry/mesh.py``: marching
tetrahedra over a density grid and the connected-component filter.
The library is built with g++ at first use into ``intrinsicnerf_tpu_torch/_build/libintrinsic_native-<hash>.so``
(keyed by the source's content), never over the JAX package's
``native/libintrinsic_native.so``: the two packages must not rebuild one
file under each other.  This is host code, not a device kernel; without a
toolchain :mod:`intrinsicnerf_tpu_torch.cluster.meanshift` takes its numpy
path and says so, and the mesh tools run their numpy versions
(``_marching_tetrahedra_np``, ``_filter_components_np``: the same
algorithms, slowly), which ``mesh_backend`` names.
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
            print(f"[native] build/load of {SOURCE} failed, mean-shift and the mesh tools "
                  f"use numpy: {e}")
            return None
        lib.estimate_bandwidth_kth.restype = ctypes.c_double
        lib.estimate_bandwidth_kth.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int64]
        lib.meanshift_iterate.restype = None
        lib.meanshift_iterate.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        lib.mc_run.restype = ctypes.c_int
        lib.mc_run.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_float]
        lib.mc_num_vertices.restype = ctypes.c_int64
        lib.mc_num_triangles.restype = ctypes.c_int64
        for name in ("mc_copy_vertices", "mc_copy_triangles"):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.mc_free.restype = None
        lib.filter_small_components.restype = ctypes.c_int64
        lib.filter_small_components.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                                ctypes.c_int64, ctypes.c_void_p]
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


def mesh_backend() -> str:
    """Which path the mesh tools take: ``"native C++"`` or ``"numpy"``."""
    return "native C++" if load() is not None else "numpy"


def marching_cubes(grid: np.ndarray, level: float) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of ``grid [nx, ny, nz]`` at ``level`` by marching
    tetrahedra; returns (vertices [V, 3] in grid coordinates, triangles
    [T, 3] int64), the triangles wound so that their normals point
    toward the increasing field."""
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be [nx, ny, nz], got {grid.shape}")
    lib = load()
    if lib is None:
        return _marching_tetrahedra_np(grid, level)
    with _lock:  # the library keeps its mesh in one global between the calls
        if lib.mc_run(grid.ctypes.data, *grid.shape, level) != 0:
            raise ValueError(f"marching_cubes failed on grid shape {grid.shape}")
        verts = np.empty((lib.mc_num_vertices(), 3), np.float32)
        tris = np.empty((lib.mc_num_triangles(), 3), np.int64)
        if len(verts):
            lib.mc_copy_vertices(verts.ctypes.data)
        if len(tris):
            lib.mc_copy_triangles(tris.ctypes.data)
        lib.mc_free()
    return verts, tris


def filter_small_components(triangles: np.ndarray, n_verts: int, min_faces: int) -> np.ndarray:
    """Keep-mask over the triangles whose connected component has at least
    ``min_faces`` faces; ``min_faces < 0`` keeps only the largest
    component (open3d's ``keep_single_cluster``)."""
    triangles = np.ascontiguousarray(triangles, np.int64).reshape(-1, 3)
    lib = load()
    if lib is None:
        return _filter_components_np(triangles, n_verts, min_faces)
    mask = np.empty(len(triangles), np.uint8)
    lib.filter_small_components(triangles.ctypes.data, len(triangles), n_verts, min_faces,
                                mask.ctypes.data)
    return mask.astype(bool)


# ------------------------------------------------------- numpy versions

_TETS = np.array([[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7],
                  [0, 4, 5, 7]])


def _marching_tetrahedra_np(grid: np.ndarray, level: float):
    """The library's marching tetrahedra in numpy and Python loops: the
    same six tetrahedra per cube, the same shared edge vertices, the same
    winding.  Slow; for small grids and hosts without a compiler."""
    nx, ny, nz = grid.shape
    verts: list = []
    tris: list = []
    edge_cache: dict = {}

    def gid(x, y, z):
        return (x * ny + y) * nz + z

    def vert(ga, gb, va, vb):
        key = (ga, gb) if ga < gb else (gb, ga)
        if key in edge_cache:
            return edge_cache[key]
        t = 0.5 if vb == va else np.clip((level - va) / (vb - va), 0, 1)
        ax, ay, az = ga // (ny * nz), (ga // nz) % ny, ga % nz
        bx, by, bz = gb // (ny * nz), (gb // nz) % ny, gb % nz
        idx = len(verts)
        verts.append([ax + t * (bx - ax), ay + t * (by - ay), az + t * (bz - az)])
        edge_cache[key] = idx
        return idx

    def pos(g):
        return np.array([g // (ny * nz), (g // nz) % ny, g % nz], float)

    def emit(v0, v1, v2, in_dir):
        a, b, c = (np.asarray(verts[v]) for v in (v0, v1, v2))
        n = np.cross(b - a, c - a)
        if float(np.dot(n, in_dir)) > 0:
            v1, v2 = v2, v1
        tris.append([v0, v1, v2])

    for x in range(nx - 1):
        for y in range(ny - 1):
            for z in range(nz - 1):
                cg = [gid(x + (c & 1), y + ((c >> 1) & 1), z + ((c >> 2) & 1)) for c in range(8)]
                cv = [grid.flat[g] for g in cg]
                for tet in _TETS:
                    inside = [i for i in range(4) if cv[tet[i]] > level]
                    outside = [i for i in range(4) if cv[tet[i]] <= level]
                    if not inside or not outside:
                        continue
                    ci = np.mean([pos(cg[tet[i]]) for i in inside], axis=0)
                    co = np.mean([pos(cg[tet[o]]) for o in outside], axis=0)
                    in_dir = ci - co
                    if len(inside) == 1:
                        a = tet[inside[0]]
                        vs = [vert(cg[a], cg[tet[o]], cv[a], cv[tet[o]]) for o in outside]
                        emit(vs[0], vs[1], vs[2], in_dir)
                    elif len(inside) == 3:
                        a = tet[outside[0]]
                        vs = [vert(cg[a], cg[tet[i]], cv[a], cv[tet[i]]) for i in inside]
                        emit(vs[0], vs[1], vs[2], in_dir)
                    else:
                        a0, a1 = (tet[i] for i in inside)
                        b0, b1 = (tet[o] for o in outside)
                        v00 = vert(cg[a0], cg[b0], cv[a0], cv[b0])
                        v01 = vert(cg[a0], cg[b1], cv[a0], cv[b1])
                        v10 = vert(cg[a1], cg[b0], cv[a1], cv[b0])
                        v11 = vert(cg[a1], cg[b1], cv[a1], cv[b1])
                        emit(v00, v10, v11, in_dir)
                        emit(v00, v11, v01, in_dir)
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(tris, np.int64).reshape(-1, 3))


def _filter_components_np(triangles, n_verts, min_faces):
    """The library's union-find component filter in numpy."""
    parent = np.arange(n_verts)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for t in triangles:
        a, b, c = (find(v) for v in t)
        parent[a] = b
        parent[find(b)] = find(c)
    roots = np.array([find(t[0]) for t in triangles])
    if len(roots) == 0:
        return np.zeros(0, bool)
    _, inv, counts = np.unique(roots, return_inverse=True, return_counts=True)
    if min_faces < 0:  # keep_single_cluster: only the largest component
        return inv == np.argmax(counts)
    return counts[inv] >= min_faces
