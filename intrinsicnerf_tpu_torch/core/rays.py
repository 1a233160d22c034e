"""Pinhole camera rays (opencv / opengl conventions) and NDC.

Port of ``intrinsicnerf_tpu/core/rays.py``: per-image ray blocks
``[B, H*W, 11] = [origin(3), dir(3), near, far, viewdir(3)]``.
"""

from __future__ import annotations

import torch


def camera_ray_dirs(
    h: int,
    w: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    convention: str = "opencv",
    euclidean_depth: bool = False,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Per-pixel camera-frame ray directions ``[H, W, 3]``; pixel centers
    at integer coordinates (i=column, j=row), ``(i - cx) / fx``."""
    i = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    j = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    x = (i - cx) / fx
    if convention == "opencv":
        y = (j - cy) / fy
        z = torch.ones_like(x)
    elif convention == "opengl":
        y = -(j - cy) / fy
        z = -torch.ones_like(x)
    else:
        raise ValueError(f"unknown convention: {convention}")
    dirs = torch.stack([x, y, z], dim=-1)
    if euclidean_depth:
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs


def rays_to_world(c2w: torch.Tensor, dirs_cam: torch.Tensor):
    """Rotate camera-frame dirs ``[..., N, 3]`` by ``c2w[..., :3, :3]`` and
    broadcast the origins.  Returns (origins, dirs_world), both ``[..., N, 3]``."""
    rot = c2w[..., :3, :3]
    dirs_w = torch.einsum("...ij,...nj->...ni", rot, dirs_cam)
    origins = c2w[..., None, :3, -1].expand(dirs_w.shape)
    return origins, dirs_w


def create_rays(
    c2w: torch.Tensor,
    h: int,
    w: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    near: float,
    far: float,
    convention: str = "opencv",
    euclidean_depth: bool = False,
) -> torch.Tensor:
    """Per-image ray pool ``[B, H*W, 11]`` on ``c2w``'s device."""
    dirs_cam = camera_ray_dirs(
        h, w, fx, fy, cx, cy, convention, euclidean_depth, device=c2w.device
    ).reshape(-1, 3)
    if c2w.ndim == 2:
        c2w = c2w[None]
    origins, dirs_w = rays_to_world(c2w, dirs_cam[None, :, :])
    viewdirs = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    nf = torch.tensor([near, far], dtype=dirs_w.dtype, device=dirs_w.device)
    nf = nf.expand(*dirs_w.shape[:-1], 2)
    return torch.cat([origins, dirs_w, nf, viewdirs], dim=-1)


def ndc_rays(h: int, w: int, focal: float, near: float, rays_o, rays_d):
    """Shift rays to the near plane and project to NDC (forward-facing LLFF)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
