"""Inputs made from the seed, on the device: cameras, rays, ground truth
and network weights.

The published datasets are not in the image, so a configuration's views
keep their published shapes (count, size, camera model, depth range,
class count) and get their content from the seed: poses, pixel colours,
depths, labels and masks.  Everything is drawn by one ``torch.Generator``
on the device in a few large calls.  The pools follow the training
bench's synthetic pools (uniform-noise colours, depths in [1, 5], labels
over every class with void), at the configuration's real view counts.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference import nerf


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one kind of input (``stream``) of run ``seed``."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % (1 << 63))


DENSITY_BIAS = 1.0


def make_weights(arch: dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Both levels' parameters under the published names, float32, drawn
    as the published initialisation ``U(+-1/sqrt(fan_in))`` in one call,
    the density head's bias then set to ``DENSITY_BIAS``: at that
    initialisation the trunk's features shrink about six-fold a layer, so
    the density is close to its bias everywhere, and a negative bias
    leaves the field empty (every view background, every gradient zero)
    while one near zero puts each ray's opacity on the sign of its last
    sample.  A unit density fills the field, as a trained one is filled,
    and keeps every ray's opacity away from that step.  (Larger weights,
    which keep the features' size through the trunk, make the render so
    sensitive that bfloat16 and float8 round-off overlap.)"""
    shapes = nerf.layer_shapes(arch)
    bounds = nerf.init_bounds(shapes)
    sizes = [math.prod(s) for s in shapes.values()]
    levels = ("coarse", "fine") if arch["n_importance"] > 0 else ("coarse",)
    flat = torch.rand(len(levels), sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for li, lvl in enumerate(levels):
        leaves, i = {}, 0
        for (name, shape), size in zip(shapes.items(), sizes):
            leaves[name] = (flat[li, i:i + size] * bounds[name]).reshape(shape).contiguous()
            i += size
        leaves["alpha_linear.bias"] = torch.full_like(leaves["alpha_linear.bias"], DENSITY_BIAS)
        out[lvl] = leaves
    return out


def camera_dirs(h: int, w: int, focal: float, cx: float, cy: float, convention: str,
                device) -> torch.Tensor:
    """``[H*W, 3]`` pixel directions in the camera frame (pixel centres at
    integer coordinates; opencv: z forward, y down; opengl: z back, y up)."""
    j, i = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    x = (i - cx) / focal
    if convention == "opencv":
        d = torch.stack([x, (j - cy) / focal, torch.ones_like(x)], -1)
    else:
        d = torch.stack([x, -(j - cy) / focal, -torch.ones_like(x)], -1)
    return d.reshape(-1, 3)


def rays(c2w: torch.Tensor, dirs: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """``[B, H*W, 11]``: origin, direction, near, far, unit view direction."""
    d = torch.einsum("bij,nj->bni", c2w[:, :3, :3], dirs)
    o = c2w[:, None, :3, 3].expand(d.shape)
    nf = torch.tensor([near, far], device=d.device).expand(*d.shape[:-1], 2)
    return torch.cat([o, d, nf, d / d.norm(dim=-1, keepdim=True)], -1)


def room_poses(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """Cameras inside a 6 x 3 x 6 m room, each turned by a random rotation."""
    q = torch.randn(n, 4, generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    a, b, c, d = q.unbind(-1)
    rot = torch.stack([
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d], -1)
    pos = (torch.rand(n, 3, generator=gen, device=device) - 0.5) * torch.tensor(
        [6.0, 3.0, 6.0], device=device)
    c2w = torch.eye(4, device=device).repeat(n, 1, 1)
    c2w[:, :3, :3] = rot.reshape(n, 3, 3)
    c2w[:, :3, 3] = pos
    return c2w


def sphere_poses(gen: torch.Generator, n: int, radius: float, device) -> torch.Tensor:
    """OpenGL cameras on the upper hemisphere of ``radius``, looking at the
    origin, as the synthetic scenes' cameras are placed."""
    u = torch.rand(n, 2, generator=gen, device=device)
    az, el = u[:, 0] * 2 * math.pi, u[:, 1] * 1.2 - 0.1
    back = torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                        torch.sin(el)], -1)
    up_world = torch.tensor([0.0, 0.0, 1.0], device=device).expand_as(back)
    right = torch.linalg.cross(up_world, back)
    right = right / right.norm(dim=-1, keepdim=True)
    up = torch.linalg.cross(back, right)
    c2w = torch.eye(4, device=device).repeat(n, 1, 1)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2] = right, up, back
    c2w[:, :3, 3] = back * radius
    return c2w


def camera(ds: dict):
    """(h, w, focal, cx, cy, convention) of a configuration's views."""
    h, w = ds["height"], ds["width"]
    if ds["kind"] == "scene":
        focal = w / 2.0 / math.tan(math.radians(ds["hfov_deg"] / 2.0))
        return h, w, focal, (w - 1) / 2.0, (h - 1) / 2.0, "opencv"
    focal = 0.5 * w / math.tan(0.5 * ds["camera_angle_x"])
    return h, w, focal, w * 0.5, h * 0.5, "opengl"


def poses(ds: dict, gen: torch.Generator, n: int, device) -> torch.Tensor:
    if ds["kind"] == "scene":
        return room_poses(gen, n, device)
    return sphere_poses(gen, n, ds["camera_radius"], device)


def view_rays(ds: dict, gen: torch.Generator, n: int, device) -> torch.Tensor:
    """``[n, H*W, 11]``: the rays of ``n`` views at the configuration's size."""
    h, w, focal, cx, cy, conv = camera(ds)
    dirs = camera_dirs(h, w, focal, cx, cy, conv, device)
    return rays(poses(ds, gen, n, device), dirs, ds["near"], ds["far"])


def train_data(ds: dict, gen: torch.Generator, device) -> dict:
    """The training set of a configuration: for a scene, the per-image ray
    pool with colours, depths, labels (0 = void) and the per-image
    semantic flags; for an object, the pixel directions, the poses, the
    white-background colours and the object masks (a disc of random
    radius about the centre)."""
    n, h, w = ds["train_views"], ds["height"], ds["width"]
    if ds["kind"] == "scene":
        return {
            "rays": view_rays(ds, gen, n, device),
            "rgb": torch.rand(n, h * w, 3, generator=gen, device=device),
            "depth": torch.rand(n, h * w, generator=gen, device=device) * 4.0 + 1.0,
            "semantic": torch.randint(0, ds["semantic_classes"] + 1, (n, h * w), generator=gen,
                                      device=device),
            "mask_ids": torch.ones(n, dtype=torch.int64, device=device),
        }
    _, _, focal, cx, cy, conv = camera(ds)
    j, i = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    r = ((i - w / 2) ** 2 + (j - h / 2) ** 2).float().sqrt().reshape(1, -1)
    radius = (torch.rand(n, 1, generator=gen, device=device) * 0.2 + 0.25) * min(h, w)
    mask = (r < radius).float()
    colour = torch.rand(n, h * w, 3, generator=gen, device=device)
    return {
        "dirs_cam": camera_dirs(h, w, focal, cx, cy, conv, device),
        "poses": poses(ds, gen, n, device),
        "rgb": colour * mask[..., None] + (1.0 - mask[..., None]),
        "mask": mask,
    }
