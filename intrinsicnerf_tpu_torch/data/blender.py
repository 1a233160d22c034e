"""Blender synthetic dataset loaders (object-level pipeline).

Port of ``intrinsicnerf_tpu/data/blender.py``:

- ``load_blender_data``: ``transforms_{train,val,test}.json`` with RGBA
  frames; focal from ``camera_angle_x``; a 40-pose spherical render path;
- ``load_blender_intrinsic_data``: frames under ``{split}/color/<name>.png``
  with GT albedo companions at ``{split}/albedo/<name>_albedo_0001.png``;
  an 80-pose spherical path.

PNGs are read through OpenCV (``utils/image.py:imread``, RGB(A) order)
instead of ``imageio``; both decode the same 8-bit values.  ``half_res``
halves the float images with ``cv2.INTER_AREA`` and halves the focal.
``testskip`` thins the val and test splits only.  The alpha channel is
the object mask of the intrinsic-loss pair weighting; the caller
composites a white background per config.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from intrinsicnerf_tpu_torch.utils.image import imread


def _rot_x(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32)


def _rot_y(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world on a sphere looking at the origin (Blender/OpenGL
    convention), as the render-path poses are made."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    c2w = _rot_x(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_y(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def spherical_render_poses(n: int = 40, phi: float = -30.0, radius: float = 4.0):
    return np.stack([pose_spherical(angle, phi, radius)
                     for angle in np.linspace(-180, 180, n + 1)[:-1]])


@dataclass
class BlenderData:
    images: np.ndarray  # [N, H, W, 4] float RGBA in [0,1]
    poses: np.ndarray  # [N, 4, 4]
    render_poses: np.ndarray  # [M, 4, 4]
    h: int
    w: int
    focal: float
    i_split: List[np.ndarray]  # train/val/test index arrays
    albedo_images: Optional[np.ndarray] = None  # [N, H, W, 4] GT albedo


def _resize_half(imgs: np.ndarray) -> np.ndarray:
    import cv2

    n, h, w, c = imgs.shape
    out = np.zeros((n, h // 2, w // 2, c), imgs.dtype)
    for i, img in enumerate(imgs):
        out[i] = cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
    return out


def _load_splits(basedir: str, testskip: int, paths, n_kinds: int = 1):
    """(images of each kind, poses, i_split, the train meta); ``paths(split,
    frame)`` gives the frame's ``n_kinds`` PNG paths."""
    splits = ["train", "val", "test"]
    metas = {s: json.load(open(os.path.join(basedir, f"transforms_{s}.json"))) for s in splits}
    kinds = [[] for _ in range(n_kinds)]
    all_poses, counts = [], [0]
    for s in splits:
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [[] for _ in range(n_kinds)], []
        for frame in metas[s]["frames"][::skip]:
            for acc, f in zip(imgs, paths(s, frame)):
                acc.append(imread(f))
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
        for acc, im in zip(kinds, imgs):
            acc.append((np.asarray(im) / 255.0).astype(np.float32))
        all_poses.append(np.asarray(poses))
        counts.append(counts[-1] + len(poses))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    return ([np.concatenate(k, 0) for k in kinds], np.concatenate(all_poses, 0), i_split,
            metas["train"])


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1) -> BlenderData:
    (images,), poses, i_split, meta = _load_splits(
        basedir, testskip, lambda s, frame: [os.path.join(basedir, frame["file_path"] + ".png")])
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    if half_res:
        images = _resize_half(images)
        h, w, focal = h // 2, w // 2, focal / 2.0
    return BlenderData(images=images, poses=poses, render_poses=spherical_render_poses(40),
                       h=h, w=w, focal=focal, i_split=i_split)


def load_blender_intrinsic_data(basedir: str, half_res: bool = False,
                                testskip: int = 1) -> BlenderData:
    """rgb + GT-albedo pairs laid out as ``{split}/color`` and
    ``{split}/albedo`` (the blender_intrinsic layout)."""
    def paths(s, frame):
        name = os.path.basename(frame["file_path"])
        return [os.path.join(basedir, s, "color", name + ".png"),
                os.path.join(basedir, s, "albedo", name + "_albedo_0001.png")]

    (images, albedo_images), poses, i_split, meta = _load_splits(basedir, testskip, paths, 2)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    if half_res:
        images = _resize_half(images)
        albedo_images = _resize_half(albedo_images)
        h, w, focal = h // 2, w // 2, focal / 2.0
    return BlenderData(images=images, poses=poses, render_poses=spherical_render_poses(80),
                       h=h, w=w, focal=focal, i_split=i_split, albedo_images=albedo_images)


def composite_white_background(images_rgba: np.ndarray) -> np.ndarray:
    """``rgb*a + (1-a)``."""
    rgb, a = images_rgba[..., :3], images_rgba[..., 3:4]
    return rgb * a + (1.0 - a)
