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
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Tuple

from intrinsicnerf_tpu_torch.utils import trace

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
    "fused_mlp_fwd": [
        ("fused_mlp_fwd", [_P] * 6 + [_I64, _P], ctypes.c_int),
        ("fused_mlp_fwd_save", [_P] * 7 + [_I64, _P], ctypes.c_int),
        ("fused_mlp_fwd_image", [_P] * 3, ctypes.c_int),
    ],
    "fused_mlp_bwd": [
        ("fused_mlp_bwd", [_P] * 8 + [_I64, _I32, _P], ctypes.c_int),
    ],
    "fwd_probe": [
        ("fwd_probe", [_P] * 6 + [_I64] + [_I32] * 4 + [_P], ctypes.c_int),
        ("fwd_probe_image", [_P, _P, _I32, _P], ctypes.c_int),
    ],
    "clock_stamp": [
        ("clock_stamp", [_P, _P], ctypes.c_int),
    ],
    "packed_heads": [
        ("packed_heads_fwd", [_P, _I64, _I32] + [_P] * 7, ctypes.c_int),
        ("packed_heads_bwd", [_P] * 9 + [_I64, _I32, _P, _P], ctypes.c_int),
    ],
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
    (library path, seconds spent, compiler log with ``-Xptxas -v``); the
    log is kept beside the library as ``<library>.log``, so a cached build
    returns the log of the build that made it.  The seconds are those of
    the ``kernel.build`` span; the counters ``kernel.builds`` and
    ``kernel.cache_hits`` count builds and libraries found."""
    path = library_path(name)
    log_path = path + ".log"
    if os.path.exists(path) and os.path.exists(log_path):
        trace.count("kernel.cache_hits")
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    with trace.span("kernel.build", name, always=True) as building:
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
                capture_output=True, text=True, timeout=600,
                env=dict(os.environ, TMPDIR=BUILD_DIR),  # nvcc's scratch stays in the build
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}{proc.stdout}")
            log = proc.stderr + proc.stdout
            with open(tmp + ".log", "w") as f:
                f.write(log)
            os.replace(tmp + ".log", log_path)  # the log first: a library implies its log
            os.replace(tmp, path)
        finally:
            for leftover in (tmp, tmp + ".log"):
                if os.path.exists(leftover):
                    os.remove(leftover)
    trace.count("kernel.builds")
    return path, building.seconds, log


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled entry: {registers, spill_stores, spill_loads}} of every
    kernel entry in a build log of ``-Xptxas -v``."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage[entry]["spill_stores"] = int(m.group(1))
                usage[entry]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[entry]["registers"] = int(m.group(1))
    return usage


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
