"""Write the synthetic Replica-format room of ``tools_make_synthetic_replica.py``.

The tool ray-traces a textured 10-class room with numpy and writes its
PNGs through ``imageio.v2.imwrite``.  It runs here in a subprocess with
that one function supplied by the port's OpenCV writer
(:func:`intrinsicnerf_tpu_torch.utils.image.imwrite`, the same lossless
PNGs), so it needs no ``imageio``; :func:`run_with_imwrite` runs any
such script that way.

The room written in the other scene layouts, for the tests and the smoke
run (neither dataset is in the repository):

- :func:`write_scannet_from_replica`: a ScanNet scan (1296x968 JPGs,
  uint16 mm depth, raw label ids with their ``scannetv2-labels.combined.tsv``,
  poses and ``<scene>.txt`` intrinsics);
- :func:`write_replica_nyu_from_replica`: the Replica-NYU layout (NYU-13
  and NYU-34 ground truth, and "CNN" labels: the ground truth with a
  seeded share of pixels flipped).

    python -m intrinsicnerf_tpu_torch.tools.synthetic_replica OUT_DIR --frames 60
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys

import numpy as np

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


def repo_env() -> dict:
    """This process's environment with the checkout first on
    ``PYTHONPATH``, for a subprocess that imports the port."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def run_with_imwrite(script: str, args, timeout: float) -> str:
    """Run ``script args`` in a subprocess from the repo root, with
    ``imageio.v2.imwrite`` supplied from OpenCV; returns its stdout and
    raises with its stderr's tail when it fails."""
    proc = subprocess.run([sys.executable, "-c", _RUNNER, script, *map(str, args)],
                          capture_output=True, text=True, cwd=REPO, env=repo_env(),
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{script} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def write_synthetic_replica(out_dir: str, frames: int = 60, width: int = 160,
                            height: int = 120) -> str:
    """Write ``frames`` frames of the room at ``width x height`` into
    ``out_dir``; returns the tool's report line."""
    return run_with_imwrite(TOOL, [os.path.abspath(out_dir), "--frames", frames, "--width",
                                   width, "--height", height], timeout=1800).strip()


# the room's classes (1 wall, 2 floor, 3 ceiling, 4-5 cabinets, 6 table,
# 7 pillar, 8-9 spheres, 10 wall panel) as ScanNet raw ids with their
# (category, nyu40 id), as NYU-13 ids and as NYU-34 ids
ROOM_TO_SCANNET = {1: (1, "wall", 1), 2: (2, "floor", 2), 3: (41, "ceiling", 22),
                   4: (3, "cabinet", 3), 5: (169, "dresser", 17), 6: (7, "table", 7),
                   7: (94, "column", 38), 8: (86, "ball", 40), 9: (144, "lamp", 35),
                   10: (64, "picture", 11)}
ROOM_TO_NYU13 = np.array([0, 12, 5, 3, 6, 6, 10, 7, 7, 7, 8], np.uint8)
ROOM_TO_NYU34 = np.array([0, 1, 2, 19, 3, 33, 7, 32, 34, 29, 10], np.uint8)
SCANNET_SIZE = (1296, 968)  # a ScanNet colour frame, width x height
NYU_FLIP = 0.1  # the share of pixels the "CNN" labels get wrong
NYU_FLIP_SEED = 0


def _frames(src: str):
    """The Replica frame numbers of ``src``, in order."""
    return sorted(int(os.path.basename(p)[4:-4]) for p in glob.glob(os.path.join(src, "rgb",
                                                                               "rgb_*.png")))


def write_scannet_from_replica(src: str, out: str, scene_name: str = "scene0000_00",
                               size=SCANNET_SIZE) -> int:
    """Write the Replica-layout room in ``src`` as a ScanNet scan in
    ``out``: ``renders/color/<i>.jpg`` resized (bilinear) to ``size``,
    ``renders/depth/<i>.png`` (uint16 mm, nearest) and
    ``<scene>_2d-label-filt/label-filt/<i>.png`` (uint16 raw ids, nearest)
    at the same size, ``renders/pose/<i>.txt`` (4x4 camera-to-world,
    OpenCV axes), ``scannetv2-labels.combined.tsv`` and ``<scene>.txt``
    with the 90-degree camera's intrinsics at ``size``.  Returns the
    number of frames."""
    import cv2

    from intrinsicnerf_tpu_torch.utils.image import imread, imwrite

    width, height = size
    frames = _frames(src)
    traj = np.loadtxt(os.path.join(src, "traj_w_c.txt"), delimiter=" ").reshape(-1, 4, 4)
    dirs = {k: os.path.join(out, *sub) for k, sub in (
        ("color", ("renders", "color")), ("depth", ("renders", "depth")),
        ("pose", ("renders", "pose")), ("label", (f"{scene_name}_2d-label-filt", "label-filt")))}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    raw = np.zeros(len(ROOM_TO_NYU13), np.uint16)
    for room, (raw_id, _, _) in ROOM_TO_SCANNET.items():
        raw[room] = raw_id
    for i, f in enumerate(frames):
        rgb = imread(os.path.join(src, "rgb", f"rgb_{f}.png"))
        src_h, src_w = rgb.shape[:2]
        imwrite(os.path.join(dirs["color"], f"{i}.jpg"),
                cv2.resize(rgb, size, interpolation=cv2.INTER_LINEAR))
        depth = imread(os.path.join(src, "depth", f"depth_{f}.png"))
        imwrite(os.path.join(dirs["depth"], f"{i}.png"),
                cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST))
        cls = imread(os.path.join(src, "semantic_class", f"semantic_class_{f}.png"))
        imwrite(os.path.join(dirs["label"], f"{i}.png"),
                cv2.resize(raw[cls], size, interpolation=cv2.INTER_NEAREST))
        np.savetxt(os.path.join(dirs["pose"], f"{i}.txt"), traj[f], fmt="%.9f")
    with open(os.path.join(out, "scannetv2-labels.combined.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\n")
        for raw_id, name, nyu40 in sorted(ROOM_TO_SCANNET.values()):
            f.write(f"{raw_id}\t{name}\t{name}\t1\t{nyu40}\n")
    # the room's camera: f = w / 2 at its own size, pixel centres kept by
    # the bilinear resize (x' = (x + 0.5) s - 0.5)
    fx = src_w / 2.0 * width / src_w
    fy = src_w / 2.0 * height / src_h
    info = {"colorWidth": width, "colorHeight": height, "fx_color": fx, "fy_color": fy,
            "mx_color": (width - 1) / 2.0, "my_color": (height - 1) / 2.0,
            "numColorFrames": len(frames)}
    with open(os.path.join(out, f"{scene_name}.txt"), "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in info.items()))
    return len(frames)


def write_replica_nyu_from_replica(src: str, out: str) -> int:
    """Write the Replica-layout room in ``src`` in the Replica-NYU layout in
    ``out``: ``rgb/``, ``depth/`` and ``traj_w_c.txt`` copied; the ground
    truth as ``semantic_class_nyu13_remap/`` and
    ``semantic_class_nyu40_remap_nyu34/``; "CNN" predictions as
    ``CNN_semantic_class_nyu13/`` and ``CNN_semantic_class_nyu34/``: the
    ground truth with a ``NYU_FLIP`` share of its pixels (seeded) set to
    a random class.  Returns the number of frames."""
    from intrinsicnerf_tpu_torch.utils.image import imread, imwrite

    rng = np.random.default_rng(NYU_FLIP_SEED)
    for sub in ("rgb", "depth"):
        shutil.copytree(os.path.join(src, sub), os.path.join(out, sub), dirs_exist_ok=True)
    shutil.copy(os.path.join(src, "traj_w_c.txt"), os.path.join(out, "traj_w_c.txt"))
    frames = _frames(src)
    for gt_dir, cnn_dir, table, n_cls in (
            ("semantic_class_nyu13_remap", "CNN_semantic_class_nyu13", ROOM_TO_NYU13, 13),
            ("semantic_class_nyu40_remap_nyu34", "CNN_semantic_class_nyu34", ROOM_TO_NYU34, 34)):
        for d in (gt_dir, cnn_dir):
            os.makedirs(os.path.join(out, d), exist_ok=True)
        for f in frames:
            gt = table[imread(os.path.join(src, "semantic_class", f"semantic_class_{f}.png"))]
            cnn = gt.copy()
            flipped = rng.random(gt.shape) < NYU_FLIP
            cnn[flipped] = rng.integers(1, n_cls + 1, size=int(flipped.sum()))
            imwrite(os.path.join(out, gt_dir, f"semantic_class_{f}.png"), gt)
            imwrite(os.path.join(out, cnn_dir, f"semantic_class_{f}.png"), cnn)
    return len(frames)


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
