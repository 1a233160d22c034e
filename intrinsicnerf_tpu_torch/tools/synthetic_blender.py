"""Write the synthetic Blender-intrinsic object of ``tools_make_synthetic_blender.py``.

The tool ray-traces a Lambertian cluster of spheres and boxes with nine
flat albedos and writes both the standard Blender layout
(``{split}/r_N.png``, RGBA) and the blender_intrinsic companion layout
(``{split}/color``, ``{split}/albedo``) with ``transforms_{split}.json``.
It runs in a subprocess with ``imageio.v2.imwrite`` supplied by the port's
OpenCV writer (``tools/synthetic_replica.py:run_with_imwrite``), so it
needs no ``imageio``.

``write_llff_from_blender`` turns a run of such views into an LLFF
capture (``poses_bounds.npy`` and ``images_{factor}/``), for the NDC path.

    python -m intrinsicnerf_tpu_torch.tools.synthetic_blender OUT_DIR --width 800 --height 800
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from intrinsicnerf_tpu_torch.tools.synthetic_replica import REPO, run_with_imwrite

TOOL = os.path.join(REPO, "tools_make_synthetic_blender.py")


def write_synthetic_blender(out_dir: str, width: int = 64, height: int = 64, train: int = 24,
                            val: int = 1, test: int = 5) -> str:
    """Write the object at ``width x height`` with the given view counts
    into ``out_dir``; returns the tool's report line."""
    return run_with_imwrite(TOOL, [out_dir, "--width", width, "--height", height, "--train",
                                   train, "--val", val, "--test", test], timeout=1800).strip()


def write_llff_from_blender(blender_dir: str, out_dir: str, views=range(5), split: str = "train",
                            factor: int = 8, bounds=(2.0, 6.0)) -> int:
    """Write the ``views`` of a Blender split as an LLFF capture in
    ``out_dir``: each frame composited on white and shrunk by ``factor``
    (``cv2.INTER_AREA``) into ``images_{factor}/``, and ``poses_bounds.npy``
    with LLFF's [down right back] pose columns, the full-size
    ``[H, W, focal]`` and the depth ``bounds``.  Adjacent views of the
    synthetic object face it within a few tens of degrees of each other,
    as a forward-facing capture does.  Returns the number of views."""
    import cv2

    from intrinsicnerf_tpu_torch.utils.image import imread, imwrite

    meta = json.load(open(os.path.join(blender_dir, f"transforms_{split}.json")))
    frames = [meta["frames"][i] for i in views]
    os.makedirs(os.path.join(out_dir, f"images_{factor}"), exist_ok=True)
    rows = []
    for i, frame in enumerate(frames):
        rgba = imread(os.path.join(blender_dir, frame["file_path"] + ".png")) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        h, w = rgb.shape[:2]
        small = cv2.resize(rgb.astype(np.float32), (w // factor, h // factor),
                           interpolation=cv2.INTER_AREA)
        imwrite(os.path.join(out_dir, f"images_{factor}", f"image{i:03d}.png"),
                (np.clip(small, 0, 1) * 255).round().astype(np.uint8))
        c2w = np.asarray(frame["transform_matrix"], np.float64)
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        pose = np.stack([-c2w[:3, 1], c2w[:3, 0], c2w[:3, 2], c2w[:3, 3], [h, w, focal]], 1)
        rows.append(np.concatenate([pose.ravel(), bounds]))
    np.save(os.path.join(out_dir, "poses_bounds.npy"), np.stack(rows))
    return len(frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--train", type=int, default=24)
    ap.add_argument("--val", type=int, default=1)
    ap.add_argument("--test", type=int, default=5)
    args = ap.parse_args(argv)
    print(write_synthetic_blender(args.out_dir, args.width, args.height, args.train, args.val,
                                  args.test))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
