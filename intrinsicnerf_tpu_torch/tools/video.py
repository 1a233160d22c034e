"""Video writing and batch PNG -> mp4 conversion of rendered frames.

Port of ``intrinsicnerf_tpu/tools/video.py``: every modality of a render
directory (rgb, decomposition, cluster and edit frames) becomes one mp4.
Frames are read through ``utils/image.py:imread`` and written with
``cv2.VideoWriter`` (mp4v); there is no ``imageio`` fallback.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterable, List, Optional

import numpy as np

from intrinsicnerf_tpu_torch.utils.image import imread

PREFIXES = ("rgb", "albedo", "shading", "residual", "vis_depth", "vis_label", "c", "edit")


def write_video(path: str, frames: Iterable[np.ndarray], fps: int = 30) -> str:
    """An mp4 from RGB uint8 frames (grey frames are repeated to RGB)."""
    import cv2

    frames = [np.repeat(f[..., None], 3, axis=-1) if f.ndim == 2 else f[..., :3]
              for f in frames]
    if not frames:
        raise ValueError("no frames to write")
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
    writer.release()
    return path


def frames_matching(img_dir: str, prefix: str) -> List[str]:
    """Sorted frame files ``{prefix}{number}.png`` (``rgb_000.png``,
    ``c000.png``, ``edit000.png``...)."""
    pat = re.compile(rf"^{re.escape(prefix)}_?(\d+)\.png$")
    out = []
    for f in glob.glob(os.path.join(img_dir, "*.png")):
        m = pat.match(os.path.basename(f))
        if m:
            out.append((int(m.group(1)), f))
    return [f for _, f in sorted(out)]


def pngs_to_video(img_dir: str, prefix: str, out_path: str, fps: int = 30) -> str:
    files = frames_matching(img_dir, prefix)
    if not files:
        raise FileNotFoundError(f"no '{prefix}*' frames in {img_dir}")
    return write_video(out_path, [imread(f) for f in files], fps)


def generate_all(img_dir: str, out_dir: Optional[str] = None, fps: int = 30) -> List[str]:
    """Convert every modality present in a render directory; returns the
    mp4s written."""
    out_dir = out_dir or img_dir
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for prefix in PREFIXES:
        if frames_matching(img_dir, prefix):
            written.append(pngs_to_video(img_dir, prefix, os.path.join(out_dir, f"{prefix}.mp4"),
                                         fps))
    return written

