"""Alpha compositing of intrinsic radiance fields.

Port of ``intrinsicnerf_tpu/core/compositing.py`` (the reference's
``raw2outputs``):

- ``alpha = 1 - exp(-relu(sigma + noise) * dist)``, last dist = 1e10,
  dists scaled by ``|ray_d|``;
- ``weights = alpha * cumprod_exclusive(1 - alpha + 1e-10)``;
- ``disp = 1 / max(1e-10, depth/acc)`` with acc == 0 rays kept finite;
- white-background compensation on rgb/albedo/shading/semantics.

``alpha_to_weights`` has the JAX package's closed-form gradient (one
reversed cumsum) instead of autograd through the cumprod.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RawOutputs(NamedTuple):
    """Per-sample model predictions: ``[..., S, C]`` / ``[..., S]``."""

    rgb: torch.Tensor  # already albedo*shading + residual
    sigma: torch.Tensor
    albedo: torch.Tensor
    shading: torch.Tensor
    residual: torch.Tensor
    sem_logits: Optional[torch.Tensor] = None
    endpoint_feat: Optional[torch.Tensor] = None


class RenderMaps(NamedTuple):
    """Composited per-ray maps."""

    rgb: torch.Tensor  # [..., 3]
    disp: torch.Tensor  # [...]
    acc: torch.Tensor  # [...]
    weights: torch.Tensor  # [..., S]
    depth: torch.Tensor  # [...]
    albedo: torch.Tensor  # [..., 3]
    shading: torch.Tensor  # [...]
    residual: torch.Tensor  # [..., 3]
    sem_logits: Optional[torch.Tensor] = None  # [..., C]
    endpoint_feat: Optional[torch.Tensor] = None  # [..., F]
    sigma: Optional[torch.Tensor] = None  # [..., S] raw pre-noise density


def exclusive_transmittance(alpha: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """``T_i = prod_{j<i} (1 - alpha_j + eps)`` (exclusive cumprod)."""
    trans = torch.cumprod(1.0 - alpha + eps, dim=-1)
    return torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)


_EPS = 1e-10


class AlphaToWeights(torch.autograd.Function):
    """``w_i = alpha_i * T_i`` with ``T_i = prod_{j<i}(1 - alpha_j + eps)``
    and the closed-form gradient of ``core/compositing.py:_a2w_bwd``:
    ``d w_k / d alpha_i = -w_k / c_i`` for ``i < k`` (``c_i = 1 - alpha_i
    + eps``) and ``T_i`` on the diagonal, so ``galpha_i = gw_i T_i -
    (sum_{k>i} gw_k w_k) / c_i``.  ``c`` is clamped at ``eps`` so that
    alpha = 1 (where ``c`` may round to 0) stays finite; the suffix
    carries the same factor."""

    @staticmethod
    def forward(ctx, alpha):
        t = exclusive_transmittance(alpha, _EPS)
        w = alpha * t
        ctx.save_for_backward(alpha, t, w)
        return w

    @staticmethod
    def backward(ctx, gw):
        alpha, t, w = ctx.saved_tensors
        gww = gw * w
        # suffix_i = sum_{k>i} gw_k w_k (exclusive reversed cumsum)
        suffix = torch.flip(torch.cumsum(torch.flip(gww, (-1,)), dim=-1), (-1,)) - gww
        c = torch.clamp(1.0 - alpha + _EPS, min=_EPS)
        return gw * t - suffix / c


def alpha_to_weights(alpha: torch.Tensor) -> torch.Tensor:
    """``w_i = alpha_i * prod_{j<i}(1 - alpha_j + eps)``."""
    return AlphaToWeights.apply(alpha)


def composite(
    raw: RawOutputs,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
) -> RenderMaps:
    """Composite per-sample predictions into per-ray maps.

    z_vals ``[..., S]`` sorted depths; rays_d ``[..., 3]`` (dists are
    scaled by its norm); ``noise`` is pre-drawn gaussian noise on sigma
    (train only)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    sigma = raw.sigma
    if noise is not None:
        sigma = sigma + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    weights = alpha_to_weights(alpha)

    def comp_vec(x):  # [..., S, C] -> [..., C]
        return torch.sum(weights[..., None] * x, dim=-2)

    def comp_scalar(x):  # [..., S] -> [...]
        return torch.sum(weights * x, dim=-1)

    rgb_map = comp_vec(raw.rgb)
    albedo_map = comp_vec(raw.albedo)
    shading_map = comp_scalar(raw.shading)
    residual_map = comp_vec(raw.residual)
    sem_map = comp_vec(raw.sem_logits) if raw.sem_logits is not None else None
    feat_map = comp_vec(raw.endpoint_feat) if raw.endpoint_feat is not None else None

    depth_map = comp_scalar(z_vals)
    acc_map = torch.sum(weights, dim=-1)
    # the acc == 0 ray (0/0 -> NaN in the reference) takes the 1e-10 clamp
    safe_acc = torch.where(acc_map > 0, acc_map, torch.ones_like(acc_map))
    disp_map = 1.0 / torch.clamp(depth_map / safe_acc, min=1e-10)

    if white_bkgd:
        rest = 1.0 - acc_map
        rgb_map = rgb_map + rest[..., None]
        albedo_map = albedo_map + rest[..., None]
        shading_map = shading_map + rest
        if sem_map is not None:
            sem_map = sem_map + rest[..., None]

    return RenderMaps(
        rgb=rgb_map,
        disp=disp_map,
        acc=acc_map,
        weights=weights,
        depth=depth_map,
        albedo=albedo_map,
        shading=shading_map,
        residual=residual_map,
        sem_logits=sem_map,
        endpoint_feat=feat_map,
        sigma=raw.sigma,
    )
