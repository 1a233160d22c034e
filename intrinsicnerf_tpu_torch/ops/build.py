"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into ``intrinsicnerf_tpu_torch/_build/
lib<name>-<hash>.so``, keyed by the content of the source and of the
shared headers ``csrc/*.cuh``.  Pointers and the stream are passed as
Python ints; every entry that launches returns the ``cudaError_t`` of
its launches.

No ``--use_fast_math``: it turns ``sinf`` into ``__sinf``, whose error
grows with the argument, and the positional-encoding angles reach
``2^9 * |x| / scale``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures: (entry, argtypes, restype) per library
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "fused_mlp_fwd": [("fused_mlp_fwd", [_P] * 6 + [_I64, _P], ctypes.c_int)],
    "fused_mlp_bwd": [
        ("fused_mlp_bwd", [_P] * 11 + [_I64, _I32, _P], ctypes.c_int),
        ("fused_mlp_bwd_scratch", [_I64, _I32] + [ctypes.POINTER(_I64)] * 3, None),
    ],
    "fwd_probe": [("fwd_probe", [_P] * 6 + [_I64] + [_I32] * 4 + [_P], ctypes.c_int)],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return cand


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [os.path.join(CSRC, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> Tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns
    (library path, seconds spent, compiler log with ``-Xptxas -v``)."""
    path = library_path(name)
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, TMPDIR=BUILD_DIR),  # nvcc's scratch stays in the build
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0, proc.stderr + proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = ctypes.CDLL(path)
        for entry, argtypes, restype in SIGNATURES[name]:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
        _loaded[name] = lib
    return lib
