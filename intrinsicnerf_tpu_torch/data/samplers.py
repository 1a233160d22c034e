"""Neighbour-paired ray sampling from device-resident pools.

Port of ``intrinsicnerf_tpu/data/samplers.py:sample_ray_pairs``: one
random training image and ``n_rays`` random pixels (with replacement),
each with a partner at an offset in {-1, 0, 1}^2 clamped to the frame,
concatenated so that ``batch[i]`` and ``batch[i + n_rays]`` are
neighbours (the pairing contract of ``compute_intrinsic_losses``).  The
draws come from a ``torch.Generator``; ``gather_ray_pairs`` takes them
explicitly so any source of indices can feed it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
