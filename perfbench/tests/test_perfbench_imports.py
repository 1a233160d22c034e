"""Nothing the benchmark runs imports JAX or the JAX package, comparing
each module's top-level name (the part before the first dot) whole; the
reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from perfbench import run as harness

HERE = os.path.join(harness.ROOT, "perfbench")
PORT = "intrinsicnerf_tpu_torch"


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_the_jax_stack():
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert len(files) > 10
    for path in files:
        assert not set(imported_tops(path)) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        assert PORT not in set(imported_tops(path)), path
    code = ("import sys; import perfbench.reference.nerf, perfbench.reference.train, "
            "perfbench.reference.compare, perfbench.reference.config; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in ({PORT!r}, "
            "'jax', 'jaxlib', 'flax', 'intrinsicnerf_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_the_port_name_is_not_the_jax_package():
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    assert "intrinsicnerf_tpu" in harness.FORBIDDEN


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny run on the host through the driver, the port and the
    reference, then the process's modules."""
    code = f"""
import sys
sys.path.insert(0, {os.path.join(HERE, 'tests')!r})
from perfbench import run as h
from tiny import tiny_bench
r = h.run_cell(tiny_bench("lego.train", 11, trace=False))
print("FOUND", h.loaded_forbidden(), r["correct"])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2",
                                                          USE_FLAX="0"))
    assert "FOUND [] True" in out.stdout, out.stderr[-3000:]
