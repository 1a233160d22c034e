"""Write the synthetic Replica-format room of ``tools_make_synthetic_replica.py``.

The tool ray-traces a textured 10-class room with numpy and writes its
PNGs through ``imageio.v2.imwrite``.  It runs here in a subprocess with
that one function supplied by the port's OpenCV writer
(:func:`intrinsicnerf_tpu_torch.utils.image.imwrite`, the same lossless
PNGs), so it needs no ``imageio``; :func:`run_with_imwrite` runs any
such script that way.

    python -m intrinsicnerf_tpu_torch.tools.synthetic_replica OUT_DIR --frames 60
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOOL = os.path.join(REPO, "tools_make_synthetic_replica.py")

_RUNNER = """
import runpy, sys, types
from intrinsicnerf_tpu_torch.utils.image import imwrite
v2 = types.ModuleType("imageio.v2")
v2.imwrite = imwrite
pkg = types.ModuleType("imageio")
pkg.v2 = v2
sys.modules["imageio"], sys.modules["imageio.v2"] = pkg, v2
tool = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(tool, run_name="__main__")
"""


def run_with_imwrite(script: str, args, timeout: float) -> str:
    """Run ``script args`` in a subprocess from the repo root, with
    ``imageio.v2.imwrite`` supplied from OpenCV; returns its stdout and
    raises with its stderr's tail when it fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", _RUNNER, script, *map(str, args)],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{script} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def write_synthetic_replica(out_dir: str, frames: int = 60, width: int = 160,
                            height: int = 120) -> str:
    """Write ``frames`` frames of the room at ``width x height`` into
    ``out_dir``; returns the tool's report line."""
    return run_with_imwrite(TOOL, [out_dir, "--frames", frames, "--width", width,
                                   "--height", height], timeout=1800).strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    args = ap.parse_args(argv)
    print(write_synthetic_replica(args.out_dir, args.frames, args.width, args.height))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
