"""Neighbour-paired ray sampling from device-resident pools.

Port of ``intrinsicnerf_tpu/data/samplers.py:sample_ray_pairs``: one
random training image and ``n_rays`` random pixels (with replacement),
each with a partner at an offset in {-1, 0, 1}^2 clamped to the frame,
concatenated so that ``batch[i]`` and ``batch[i + n_rays]`` are
neighbours (the pairing contract of ``compute_intrinsic_losses``).  The
draws come from a ``torch.Generator``; ``gather_ray_pairs`` takes them
explicitly so any source of indices can feed it.

``render.no_batching: false`` draws each ray's image on its own
(``sample_ray_pairs_all_images``, port of the JAX function of that name):
the neighbours stay in their pixel's image, and the labels of images
without semantic supervision are voided per ray.  Its draws
(``draw_all_images_indices``) and its gather
(``gather_ray_pairs_all_images``) are split the same way.

The object pipeline's sampler (``sample_ray_pairs_from_poses``, port of
the JAX function of that name) builds the rays of the drawn pixels from
the image's pose instead of reading a ray pool, restricts the pixels to
the centre crop during the precrop warm-up, and projects to NDC for
forward-facing LLFF scenes.  Its draws (``draw_pose_pair_indices``) and
its gather (``gather_ray_pairs_from_poses``) are split the same way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import torch

from intrinsicnerf_tpu_torch.core.rays import ndc_rays


class RayBatch(NamedTuple):
    rays: torch.Tensor  # [2N, 11]
    rgb: torch.Tensor  # [2N, 3]
    depth: Optional[torch.Tensor]  # [2N]
    semantic: Optional[torch.Tensor]  # [2N] int labels (0=void) or mask
    sem_flag: torch.Tensor  # [] 1.0 if the semantic loss is active for this image
    image_idx: torch.Tensor  # [] int


def draw_pair_indices(generator: torch.Generator, num_img: int, h: int, w: int,
                      n_rays: int, device=None):
    """(img [], idx_hw [N], bias_h [N], bias_w [N]) drawn from ``generator``."""

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=generator, device=device)

    return randint(0, num_img, ()), randint(0, h * w, (n_rays,)), \
        randint(-1, 2, (n_rays,)), randint(-1, 2, (n_rays,))


def gather_ray_pairs(
    rays_pool: torch.Tensor,  # [num_img, H*W, 11]
    rgb_pool: torch.Tensor,  # [num_img, H*W, 3]
    h: int,
    w: int,
    img: torch.Tensor,  # [] image index
    idx_hw: torch.Tensor,  # [N] flat pixel indices
    bias_h: torch.Tensor,  # [N] neighbour row offsets in {-1, 0, 1}
    bias_w: torch.Tensor,  # [N] neighbour column offsets
    depth_pool: Optional[torch.Tensor] = None,  # [num_img, H*W]
    sem_pool: Optional[torch.Tensor] = None,  # [num_img, H*W]
    mask_ids: Optional[torch.Tensor] = None,  # [num_img] semantic-loss mask
) -> RayBatch:
    """The paired batch for the given draws: pixels first, then their
    neighbours (clamped to the frame)."""
    idx_h, idx_w = idx_hw // w, idx_hw % w
    nei_h = torch.clamp(idx_h + bias_h, 0, h - 1)
    nei_w = torch.clamp(idx_w + bias_w, 0, w - 1)
    idx = torch.cat([idx_hw, nei_h * w + nei_w])  # [2N]
    # the image as a 1-element index: a 0-dim tensor index is read back to
    # the host, which a CUDA graph capture refuses
    img1 = img.reshape(1)

    def gather(pool):
        return pool[img1, idx]

    sem_flag = (mask_ids[img1].float().reshape(()) if mask_ids is not None
                else torch.ones((), dtype=torch.float32, device=rays_pool.device))
    return RayBatch(
        rays=gather(rays_pool),
        rgb=gather(rgb_pool),
        depth=gather(depth_pool) if depth_pool is not None else None,
        semantic=gather(sem_pool) if sem_pool is not None else None,
        sem_flag=sem_flag,
        image_idx=img,
    )


def sample_ray_pairs(
    generator: torch.Generator,
    rays_pool: torch.Tensor,
    rgb_pool: torch.Tensor,
    h: int,
    w: int,
    n_rays: int,
    depth_pool: Optional[torch.Tensor] = None,
    sem_pool: Optional[torch.Tensor] = None,
    mask_ids: Optional[torch.Tensor] = None,
) -> RayBatch:
    """``2 * n_rays`` paired rays of one random image, drawn from
    ``generator`` (on the pools' device)."""
    draws = draw_pair_indices(generator, rays_pool.shape[0], h, w, n_rays, rays_pool.device)
    return gather_ray_pairs(rays_pool, rgb_pool, h, w, *draws, depth_pool=depth_pool,
                            sem_pool=sem_pool, mask_ids=mask_ids)


def draw_all_images_indices(generator: torch.Generator, num_img: int, h: int, w: int,
                            n_rays: int, device=None):
    """(imgs [N], idx_hw [N], bias_h [N], bias_w [N]) drawn from
    ``generator``: an image and a pixel per ray, and neighbour offsets."""

    def randint(low, high):
        return torch.randint(low, high, (n_rays,), generator=generator, device=device)

    return randint(0, num_img), randint(0, h * w), randint(-1, 2), randint(-1, 2)


def gather_ray_pairs_all_images(
    rays_pool: torch.Tensor,  # [num_img, H*W, 11]
    rgb_pool: torch.Tensor,  # [num_img, H*W, 3]
    h: int,
    w: int,
    imgs: torch.Tensor,  # [N] image per ray
    idx_hw: torch.Tensor,  # [N] flat pixel indices
    bias_h: torch.Tensor,  # [N] neighbour row offsets in {-1, 0, 1}
    bias_w: torch.Tensor,  # [N] neighbour column offsets
    depth_pool: Optional[torch.Tensor] = None,  # [num_img, H*W]
    sem_pool: Optional[torch.Tensor] = None,  # [num_img, H*W]
    mask_ids: Optional[torch.Tensor] = None,  # [num_img] semantic-loss mask
) -> RayBatch:
    """The paired batch for the given draws, each ray from its own image:
    pixels first, then their neighbours (clamped to the frame, in the
    same image).  Gathers from the flattened ``[num_img * H*W, ...]``
    pools with one ``[2N]`` index, so nothing is read back to the host;
    rays of images with ``mask_ids == 0`` get the void label 0."""
    idx_h, idx_w = idx_hw // w, idx_hw % w
    nei_h = torch.clamp(idx_h + bias_h, 0, h - 1)
    nei_w = torch.clamp(idx_w + bias_w, 0, w - 1)
    imgs2 = torch.cat([imgs, imgs])
    flat_idx = imgs2 * (h * w) + torch.cat([idx_hw, nei_h * w + nei_w])  # [2N]

    def gather(pool):
        return pool.reshape(-1, *pool.shape[2:])[flat_idx]

    semantic = gather(sem_pool) if sem_pool is not None else None
    if semantic is not None and mask_ids is not None:
        semantic = torch.where(mask_ids[imgs2] > 0, semantic, torch.zeros_like(semantic))
    return RayBatch(
        rays=gather(rays_pool),
        rgb=gather(rgb_pool),
        depth=gather(depth_pool) if depth_pool is not None else None,
        semantic=semantic,
        sem_flag=torch.ones((), dtype=torch.float32, device=rays_pool.device),
        image_idx=imgs[0],
    )


def sample_ray_pairs_all_images(
    generator: torch.Generator,
    rays_pool: torch.Tensor,
    rgb_pool: torch.Tensor,
    h: int,
    w: int,
    n_rays: int,
    depth_pool: Optional[torch.Tensor] = None,
    sem_pool: Optional[torch.Tensor] = None,
    mask_ids: Optional[torch.Tensor] = None,
) -> RayBatch:
    """``2 * n_rays`` paired rays, each pair from an image drawn uniformly
    over the whole training set (the ``no_batching: false`` mode), drawn
    from ``generator`` on the pools' device."""
    draws = draw_all_images_indices(generator, rays_pool.shape[0], h, w, n_rays,
                                    rays_pool.device)
    return gather_ray_pairs_all_images(rays_pool, rgb_pool, h, w, *draws, depth_pool=depth_pool,
                                       sem_pool=sem_pool, mask_ids=mask_ids)


def _crop_half(size: int, frac: float) -> int:
    """``max(int(size // 2 * frac), 1)`` in fp32, as the JAX sampler
    computes its crop's half-extent."""
    return max(int(np.float32(size // 2) * np.float32(frac)), 1)


def draw_pose_pair_indices(generator: torch.Generator, num_img: int, h: int, w: int,
                           n_rays: int, step=None, precrop_iters: int = 0,
                           precrop_frac: float = 0.5, device=None):
    """(img [], idx_h [N], idx_w [N], bias_h [N], bias_w [N]) drawn from
    ``generator``: absolute pixel rows and columns, and neighbour offsets.

    With ``precrop_iters`` > 0 the pixels lie in the centre crop of
    fraction ``precrop_frac`` while the device counter ``step`` is below
    ``precrop_iters``, and in the crop of fraction 1.0 after it (as in the
    JAX sampler, which keeps its crop branch: an odd ``h`` never draws its
    last row).  Both crops are drawn at their static bounds every step and
    ``step`` picks one on the device, so the draws advance the generator
    the same way at every step and read nothing back to the host."""
    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=generator, device=device)

    img = randint(0, num_img, ())
    if precrop_iters > 0:
        rows, cols = [], []
        for frac in (precrop_frac, 1.0):
            dh, dw = _crop_half(h, frac), _crop_half(w, frac)
            rows.append(h // 2 - dh + randint(0, 2 * dh, (n_rays,)))
            cols.append(w // 2 - dw + randint(0, 2 * dw, (n_rays,)))
        in_crop = torch.as_tensor(step, device=rows[0].device) < precrop_iters
        idx_h = torch.where(in_crop, rows[0], rows[1])
        idx_w = torch.where(in_crop, cols[0], cols[1])
    else:
        idx_h, idx_w = randint(0, h, (n_rays,)), randint(0, w, (n_rays,))
    return img, idx_h, idx_w, randint(-1, 2, (n_rays,)), randint(-1, 2, (n_rays,))


def gather_ray_pairs_from_poses(
    dirs_cam: torch.Tensor,  # [H*W, 3] shared camera-frame pixel dirs
    poses: torch.Tensor,  # [num_img, 4, 4] c2w
    rgb_pool: torch.Tensor,  # [num_img, H*W, 3]
    h: int,
    w: int,
    img: torch.Tensor,  # [] image index
    idx_h: torch.Tensor,  # [N] pixel rows
    idx_w: torch.Tensor,  # [N] pixel columns
    bias_h: torch.Tensor,  # [N] neighbour row offsets in {-1, 0, 1}
    bias_w: torch.Tensor,  # [N] neighbour column offsets
    near: float,
    far: float,
    mask_pool: Optional[torch.Tensor] = None,  # [num_img, H*W] object mask
    ndc_focal: Optional[float] = None,  # set -> project the rays to NDC (LLFF)
) -> RayBatch:
    """The paired batch of the given draws, its rays made from the image's
    pose: pixels first, then their neighbours (clamped to the frame).
    With ``ndc_focal`` the rays march in NDC with bounds [0, 1] and the
    view directions stay in world space."""
    nei_h = torch.clamp(idx_h + bias_h, 0, h - 1)
    nei_w = torch.clamp(idx_w + bias_w, 0, w - 1)
    idx = torch.cat([idx_h * w + idx_w, nei_h * w + nei_w])  # [2N]
    img1 = img.reshape(1)  # a 1-element index: no read back to the host
    c2w = poses[img1][0]
    d_world = dirs_cam[idx] @ c2w[:3, :3].T
    origins = c2w[:3, 3].expand(d_world.shape)
    viewdirs = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    if ndc_focal is not None:
        origins, d_world = ndc_rays(h, w, ndc_focal, 1.0, origins, d_world)
        near, far = 0.0, 1.0
    # filled on the device: a host tensor copied in would break a graph capture
    nf = d_world.new_full((d_world.shape[0], 2), near)
    nf[:, 1] = far
    rays = torch.cat([origins, d_world, nf, viewdirs], dim=-1)
    return RayBatch(
        rays=rays,
        rgb=rgb_pool[img1, idx],
        depth=None,
        semantic=mask_pool[img1, idx] if mask_pool is not None else None,
        sem_flag=torch.zeros((), dtype=torch.float32, device=rays.device),
        image_idx=img,
    )


def sample_ray_pairs_from_poses(
    generator: torch.Generator,
    dirs_cam: torch.Tensor,
    poses: torch.Tensor,
    rgb_pool: torch.Tensor,
    h: int,
    w: int,
    n_rays: int,
    near: float,
    far: float,
    mask_pool: Optional[torch.Tensor] = None,
    step=None,
    precrop_iters: int = 0,
    precrop_frac: float = 0.5,
    ndc_focal: Optional[float] = None,
) -> RayBatch:
    """``2 * n_rays`` paired rays of one random image, built from its pose
    (the object pipeline's sampler), drawn from ``generator`` on the
    pools' device; the precrop warm-up reads the device counter ``step``."""
    draws = draw_pose_pair_indices(generator, poses.shape[0], h, w, n_rays, step, precrop_iters,
                                   precrop_frac, poses.device)
    return gather_ray_pairs_from_poses(dirs_cam, poses, rgb_pool, h, w, *draws, near, far,
                                       mask_pool=mask_pool, ndc_focal=ndc_focal)
