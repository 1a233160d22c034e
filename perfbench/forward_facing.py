"""Forward-facing inputs made from the seed, on the device: the cameras of
a hand-held capture as LLFF's loader leaves them, their rays, and the
training pools of the pose sampler.

A configuration of kind ``forward_facing`` keeps its published shapes
(view count, size, field of view) and gets its content from the seed:
camera centres spread over a small box in front of the scene, each
camera tilted a little, then recentred as ``load_llff_data`` recentres
(the mean pose becomes the identity: centres about 0, looking down -z in
OpenGL's convention); colours uniform noise, no background; masks all
ones, since an LLFF capture has no alpha channel.  The rays are made in
world space with the dataset's near and far (0 and 1, the NDC range)
and projected to NDC by whoever consumes them.  Each kind of input is
drawn by its own ``torch.Generator`` (``scenes.generator``).
"""

from __future__ import annotations

import math

import torch

from perfbench import scenes


def focal(ds: dict) -> float:
    """The views' focal length in pixels."""
    return 0.5 * ds["width"] / math.tan(0.5 * ds["camera_angle_x"])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / v.norm(dim=-1, keepdim=True)


def _tilts(gen: torch.Generator, n: int, tilt: float, device) -> torch.Tensor:
    """``[n, 3, 3]`` rotations by an axis-angle vector uniform in
    ``+-tilt`` on each axis (Rodrigues' formula)."""
    v = (torch.rand(n, 3, generator=gen, device=device) * 2.0 - 1.0) * tilt
    angle = v.norm(dim=-1).clamp(min=1e-12)[:, None, None]
    k = torch.zeros(n, 3, 3, device=device)
    a = v / angle[:, :, 0]
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -a[:, 2], a[:, 1], -a[:, 0]
    k = k - k.transpose(1, 2)
    eye = torch.eye(3, device=device).expand(n, 3, 3)
    return eye + torch.sin(angle) * k + (1.0 - torch.cos(angle)) * (k @ k)


def recentre(c2w: torch.Tensor) -> torch.Tensor:
    """``load_llff_data``'s ``recenter_poses``: the poses in the frame of
    their average (the mean centre; the normalised sum of the back axes,
    and the sum of the up axes made orthogonal to it)."""
    back = _unit(c2w[:, :3, 2].sum(0))
    right = _unit(torch.linalg.cross(c2w[:, :3, 1].sum(0), back))
    avg = torch.eye(4, device=c2w.device)
    avg[:3, 0], avg[:3, 1], avg[:3, 2] = right, torch.linalg.cross(back, right), back
    avg[:3, 3] = c2w[:, :3, 3].mean(0)
    return torch.linalg.inv(avg) @ c2w


def poses(ds: dict, gen: torch.Generator, n: int, device) -> torch.Tensor:
    """``[n, 4, 4]`` OpenGL camera-to-world poses of a forward-facing
    capture, recentred."""
    spread = torch.tensor(ds["position_spread"], device=device)
    c2w = torch.eye(4, device=device).repeat(n, 1, 1)
    c2w[:, :3, :3] = _tilts(gen, n, ds["tilt_rad"], device)
    c2w[:, :3, 3] = (torch.rand(n, 3, generator=gen, device=device) * 2.0 - 1.0) * spread
    return recentre(c2w)


def camera_dirs(ds: dict, device) -> torch.Tensor:
    """``[H*W, 3]`` camera-frame pixel directions (OpenGL, ``cx = W/2``)."""
    h, w, f = ds["height"], ds["width"], focal(ds)
    return scenes.camera_dirs(h, w, f, w * 0.5, h * 0.5, "opengl", device)


def view_rays(ds: dict, gen: torch.Generator, n: int, device) -> torch.Tensor:
    """``[n, H*W, 11]`` world-space rays of ``n`` seeded views."""
    return scenes.rays(poses(ds, gen, n, device), camera_dirs(ds, device), ds["near"], ds["far"])


def train_data(ds: dict, gen: torch.Generator, device) -> dict:
    """The pose sampler's pools: the pixel directions, the training
    views' poses, their colours and their masks."""
    n, hw = ds["train_views"], ds["height"] * ds["width"]
    return {"dirs_cam": camera_dirs(ds, device), "poses": poses(ds, gen, n, device),
            "rgb": torch.rand(n, hw, 3, generator=gen, device=device),
            "mask": torch.ones(n, hw, device=device)}
