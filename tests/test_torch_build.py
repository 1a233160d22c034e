"""``ops/build.py``'s cache, with a stand-in for nvcc.

A build that finds its library already compiled must still return the
compiler's log: ``chip_smoke.py`` reads kernel 3's registers and spills
from it, and a second run in the same checkout finds every library cached.
"""

import os
import stat
import sys

import pytest

from intrinsicnerf_tpu_torch.ops import build

PTXAS_LOG = (
    "ptxas info    : Compiling entry function '_Z6kernelILi0EEvv' for 'sm_90a'\n"
    "ptxas info    : Function properties for _Z6kernelILi0EEvv\n"
    "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
    "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]\n"
)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A compiler that writes its ``-o`` target, prints ``PTXAS_LOG`` and
    counts its runs in ``runs``."""
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        f"open({str(runs)!r}, 'a').write('x')\n"
        f"sys.stderr.write({PTXAS_LOG!r})\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    return lambda: len(runs.read_text()) if runs.exists() else 0


def test_cached_build_returns_its_log(fake_nvcc):
    path, _, log = build.build("fwd_probe")
    assert fake_nvcc() == 1 and os.path.exists(path) and log == PTXAS_LOG
    again, secs, cached_log = build.build("fwd_probe")
    assert fake_nvcc() == 1, "a cached library was compiled again"
    assert (again, secs, cached_log) == (path, 0.0, PTXAS_LOG)
    assert build.ptxas_usage(cached_log) == {
        "_Z6kernelILi0EEvv": {"registers": 168, "spill_stores": 8, "spill_loads": 4}}
    assert sorted(os.listdir(build.BUILD_DIR)) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".log"])


def test_library_without_its_log_is_rebuilt(fake_nvcc):
    path, _, _ = build.build("fwd_probe")
    os.remove(path + ".log")
    _, _, log = build.build("fwd_probe")
    assert fake_nvcc() == 2 and log == PTXAS_LOG
