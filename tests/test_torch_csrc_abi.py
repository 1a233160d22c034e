"""The ctypes signatures of ``ops/build.py`` against the kernels' C entries.

The kernel libraries are loaded with ctypes, which converts each argument
by the ``argtypes`` that ``build.SIGNATURES`` gives it.  A pointer passed
where the C function takes a 32-bit int, or an int where it takes a
``long long``, is cut or misread silently, and only on the card.  So this
test parses every ``extern "C"`` entry in ``ops/csrc/*.cu`` and holds its
return type, its parameter count and each parameter's kind (pointer,
64-bit int, int) against the signature the wrapper declares.
"""

import ctypes
import glob
import os
import re

import pytest

from intrinsicnerf_tpu_torch.ops import build

ENTRY = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _c_kind(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "pointer"
    if re.search(r"\blong\s+long\b", param) or "int64_t" in param:
        return "i64"
    if re.search(r"\bint\b", param):
        return "i32"
    raise AssertionError(f"unrecognised C parameter {param!r}")


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type) and issubclass(t, ctypes._Pointer)):
        return "pointer"
    if t is ctypes.c_longlong:
        return "i64"
    if t is ctypes.c_int:
        return "i32"
    raise AssertionError(f"unrecognised ctypes type {t!r}")


def _c_entries(name: str):
    with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    return {fn: (ret, [_c_kind(p) for p in params.split(",") if p.strip()])
            for ret, fn, params in ENTRY.findall(src)}


def test_every_source_has_signatures():
    sources = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(build.CSRC, "*.cu"))}
    assert sources == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_ctypes_signatures_match_c_entries(name):
    entries = _c_entries(name)
    declared = {entry: (argtypes, restype) for entry, argtypes, restype in build.SIGNATURES[name]}
    assert set(entries) == set(declared), name
    for entry, (ret, kinds) in entries.items():
        argtypes, restype = declared[entry]
        assert [_ctypes_kind(t) for t in argtypes] == kinds, entry
        assert restype == (None if ret == "void" else ctypes.c_int), entry
        assert ret in ("void", "int"), entry
