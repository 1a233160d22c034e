"""LLFF forward-facing dataset (object-level pipeline).

Port of ``intrinsicnerf_tpu/data/llff.py`` (numpy, read with OpenCV as
there, with one fault repaired: the focal follows the images when they
are read from a shrunk ``images_{factor}`` directory, as in the original
loader): ``poses_bounds.npy`` rows of [3x5 pose+hwf | near far], images
under ``images/`` (or a downsampled ``images_{factor}`` directory), pose
recentering around the average camera, optional spherification for
inward-facing captures, a spiral render path, and the every-8th-image
holdout split.  Poses are converted from LLFF's [down right back] to
NeRF's [right up back] axis order.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p34 = np.concatenate([poses[:, :3, :4], bottom], -2)
    p34 = np.linalg.inv(c2w) @ p34
    poses_[:, :3, :4] = p34[:, :3, :4]
    return poses_


def spiral_render_path(c2w, up, rads, focal, zrate=0.5, rots=2, n=120):
    render_poses = []
    rads = np.asarray(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return np.stack(render_poses)


def spherify_poses(poses, bds):
    """Recenter inward-facing captures onto a sphere and produce a
    circular render path."""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        return np.squeeze(
            -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
            @ (b_i).mean(0)
        )

    pt_mindist = min_line_dist(rays_o, rays_d)
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        p = np.stack([vec0, vec1, vec2, camorigin], 1)
        new_poses.append(p)
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        -1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        -1,
    )
    return poses_reset, new_poses, bds


@dataclass
class LLFFData:
    images: np.ndarray  # [N, H, W, 3]
    poses: np.ndarray  # [N, 3, 5] (rotation | translation | hwf)
    bds: np.ndarray  # [N, 2]
    render_poses: np.ndarray  # [M, 3, 5]
    i_test: int
    h: int
    w: int
    focal: float


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
) -> LLFFData:
    import cv2

    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    # a copy: the JAX loader's poses are a view of ``arr``, so writing the
    # image size into them also overwrote the full-size width it then
    # scales the focal by, and a shrunk ``images_{factor}`` kept the
    # full-size focal
    poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0]).copy()
    bds = arr[:, -2:].transpose([1, 0])

    img_dir = os.path.join(basedir, f"images_{factor}" if factor > 1 else "images")
    if not os.path.exists(img_dir):
        img_dir = os.path.join(basedir, "images")
    img_files = sorted(
        f
        for f in glob.glob(os.path.join(img_dir, "*"))
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    imgs = []
    for f in img_files:
        img = cv2.imread(f)[:, :, ::-1] / 255.0
        imgs.append(img.astype(np.float32))
    imgs = np.stack(imgs, -1)  # [H, W, 3, N]

    # scale intrinsics if images were pre-downsampled
    sh = imgs.shape[:2]
    poses[:2, 4, :] = np.array(sh).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * sh[1] / arr[0, :-2].reshape(3, 5)[1, 4]

    # [down right back] -> [right up back]
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1
    )
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        render_poses = spiral_render_path(c2w, up, rads, focal, zrate=0.5, rots=2)

    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    h, w, f = poses[0, :3, -1]
    return LLFFData(
        images=imgs,
        poses=poses,
        bds=bds,
        render_poses=np.asarray(render_poses, np.float32),
        i_test=i_test,
        h=int(h),
        w=int(w),
        focal=float(f),
    )
