"""DeepVoxels and LINEMOD dataset loaders (object-level pipeline).

Port of ``intrinsicnerf_tpu/data/deepvoxels.py``: ``load_dv_data``, per
split ``{train,validation,test}/<scene>/{intrinsics.txt,pose/*.txt,rgb/*}``
with the intrinsics file carrying focal/center/near/scale; and
``load_linemod_data``, blender-style transforms JSON with absolute frame
paths plus a K matrix.  Frames are read through OpenCV
(``utils/image.py:imread``) instead of ``imageio``.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from intrinsicnerf_tpu_torch.data.blender import BlenderData, spherical_render_poses
from intrinsicnerf_tpu_torch.utils.image import imread


def parse_dv_intrinsics(path: str, target_sidelength: int):
    with open(path) as f:
        vals = list(map(float, f.readline().split()))
        focal, cx, cy = vals[0], vals[1], vals[2]
        _barycenter = np.array(list(map(float, f.readline().split())))
        near = float(f.readline())
        _scale = float(f.readline())
        height, width = map(float, f.readline().split())
    cx = cx / width * target_sidelength
    cy = cy / height * target_sidelength
    focal = target_sidelength / height * focal
    return focal, cx, cy, near


@dataclass
class DeepVoxelsData:
    images: np.ndarray  # [N, H, W, 3]
    poses: np.ndarray  # [N, 4, 4]
    render_poses: np.ndarray
    h: int
    w: int
    focal: float
    near: float
    i_split: List[np.ndarray]


def load_dv_data(
    scene: str = "cube", basedir: str = "data/deepvoxels", testskip: int = 8
) -> DeepVoxelsData:
    h = w = 512
    focal, cx, cy, near = parse_dv_intrinsics(
        os.path.join(basedir, "train", scene, "intrinsics.txt"), h
    )

    def load_split(split, skip):
        base = os.path.join(basedir, split, scene)
        pose_files = sorted(glob.glob(os.path.join(base, "pose", "*.txt")))[::skip]
        img_files = sorted(
            glob.glob(os.path.join(base, "rgb", "*"))
        )[::skip]
        poses = np.stack(
            [np.loadtxt(f).reshape(4, 4).astype(np.float32) for f in pose_files]
        )
        imgs = np.stack(
            [np.asarray(imread(f), np.float32)[..., :3] / 255.0
             for f in img_files]
        )
        return imgs, poses

    splits = [("train", 1), ("validation", testskip), ("test", testskip)]
    all_imgs, all_poses, counts = [], [], [0]
    for split, skip in splits:
        imgs, poses = load_split(split, max(skip, 1))
        all_imgs.append(imgs)
        all_poses.append(poses)
        counts.append(counts[-1] + len(imgs))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    return DeepVoxelsData(
        images=np.concatenate(all_imgs),
        poses=np.concatenate(all_poses),
        render_poses=spherical_render_poses(40, phi=-30.0, radius=4.0),
        h=h,
        w=w,
        focal=focal,
        near=near,
        i_split=i_split,
    )


def load_linemod_data(
    basedir: str, half_res: bool = False, testskip: int = 1
) -> BlenderData:
    """LINEMOD scenes in the blender-transforms format (absolute frame
    paths, per-meta K and near/far)."""
    splits = ["train", "val", "test"]
    metas = {
        s: json.load(open(os.path.join(basedir, f"transforms_{s}.json")))
        for s in splits
    }
    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            path = frame["file_path"]
            if not os.path.isabs(path) and not os.path.exists(path):
                path = os.path.join(basedir, path)
            imgs.append(imread(path))
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
        all_imgs.append((np.asarray(imgs) / 255.0).astype(np.float32))
        all_poses.append(np.asarray(poses))
        counts.append(counts[-1] + len(imgs))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    images = np.concatenate(all_imgs)
    if images.shape[-1] == 3:  # ensure alpha channel for the mask contract
        images = np.concatenate(
            [images, np.ones_like(images[..., :1])], axis=-1
        )
    poses = np.concatenate(all_poses)
    h, w = images.shape[1:3]
    k = np.asarray(metas["train"]["frames"][0]["intrinsic_matrix"], np.float32)
    focal = float(k[0, 0])
    if half_res:
        import cv2

        h, w, focal = h // 2, w // 2, focal / 2.0
        images = np.stack(
            [cv2.resize(im, (w, h), interpolation=cv2.INTER_AREA) for im in images]
        )
    data = BlenderData(
        images=images,
        poses=poses,
        render_poses=spherical_render_poses(40),
        h=h,
        w=w,
        focal=focal,
        i_split=i_split,
    )
    return data
