"""Hierarchical coarse/fine volumetric rendering.

Port of ``intrinsicnerf_tpu/render/pipeline.py``: stratified coarse
samples -> coarse MLP -> composite -> inverse-CDF resample from the
interior coarse weights (detached) -> merge with the coarse depths ->
fine MLP -> composite.

The JAX version splits a PRNG key for the train-time draws.  Here they
are injected tensors (``t_rand``, ``noise_c``, ``u``, ``noise_f``) so any
source of random numbers can feed them; ``draw_train_noise`` makes them
from a ``torch.Generator``, and the eval path needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from intrinsicnerf_tpu_torch.core.compositing import RenderMaps, composite
from intrinsicnerf_tpu_torch.core.sampling import (
    merge_z_vals,
    perturb_z_vals,
    sample_pdf,
    sorted_uniforms,
    stratified_z_vals,
)
from intrinsicnerf_tpu_torch.models.mlp import MLP, MLPConfig, eval_points
from intrinsicnerf_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 64
    n_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    endpoint_feat: bool = False


class RenderResult(NamedTuple):
    coarse: RenderMaps
    fine: Optional[RenderMaps]
    z_std: Optional[torch.Tensor]  # std of the importance depths [N]


def draw_train_noise(n_rays: int, rcfg: RenderConfig, generator: torch.Generator,
                     device=None) -> Dict[str, Optional[torch.Tensor]]:
    """The train-time draws of ``render_rays`` for ``n_rays`` rays from
    ``generator`` (on ``device``): the stratified jitter ``t_rand``, the
    sigma noise ``noise_c`` / ``noise_f`` and the sorted importance
    uniforms ``u``; None where ``rcfg`` needs none."""
    nc, ni = rcfg.n_coarse, rcfg.n_importance
    fine = ni > 0
    jitter = rcfg.perturb > 0.0
    noisy = rcfg.raw_noise_std > 0.0

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    return {
        "t_rand": uniform(n_rays, nc) if jitter else None,
        "noise_c": normal(n_rays, nc) if noisy else None,
        "u": sorted_uniforms((n_rays, ni), generator, device) if fine and jitter else None,
        "noise_f": normal(n_rays, nc + ni) if fine and noisy else None,
    }


def _need(x: Optional[torch.Tensor], name: str) -> torch.Tensor:
    if x is None:
        raise ValueError(f"render_rays(train=True) needs the injected draws {name}=")
    return x


def render_rays(
    model_coarse: MLP,
    model_fine: Optional[MLP],
    mlp_cfg: MLPConfig,
    rays: torch.Tensor,  # [N, 11] = [o(3), d(3), near, far, viewdir(3)]
    rcfg: RenderConfig,
    train: bool = False,
    t_rand: Optional[torch.Tensor] = None,  # [N, n_coarse] U(0,1) jitter
    noise_c: Optional[torch.Tensor] = None,  # [N, n_coarse] N(0,1)
    u: Optional[torch.Tensor] = None,  # [N, n_importance] sorted U(0,1)
    noise_f: Optional[torch.Tensor] = None,  # [N, n_coarse+n_importance] N(0,1)
) -> RenderResult:
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    near, far = rays[..., 6:7], rays[..., 7:8]
    viewdirs = rays[..., 8:11] if rays.shape[-1] > 8 else None
    noisy = train and rcfg.raw_noise_std > 0.0

    z_vals = stratified_z_vals(near, far, rcfg.n_coarse, rcfg.lindisp)
    z_vals = z_vals.expand(*rays.shape[:-1], rcfg.n_coarse)
    if train and rcfg.perturb > 0.0:
        z_vals = perturb_z_vals(z_vals, _need(t_rand, "t_rand"))

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw_c = eval_points(model_coarse, mlp_cfg, pts, viewdirs)
    nc = _need(noise_c, "noise_c") * rcfg.raw_noise_std if noisy else None
    maps_c = composite(raw_c, z_vals, rays_d, nc, rcfg.white_bkgd)

    if rcfg.n_importance <= 0 or model_fine is None:
        return RenderResult(coarse=maps_c, fine=None, z_std=None)

    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    det = (rcfg.perturb == 0.0) or (not train)
    z_samples = sample_pdf(
        z_mid,
        maps_c.weights[..., 1:-1].detach(),
        rcfg.n_importance,
        det=det,
        u=None if det else _need(u, "u"),
    ).detach()
    z_all = merge_z_vals(z_vals, z_samples)

    pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    raw_f = eval_points(
        model_fine, mlp_cfg, pts_f, viewdirs, want_endpoint_feat=rcfg.endpoint_feat
    )
    nf = _need(noise_f, "noise_f") * rcfg.raw_noise_std if noisy else None
    maps_f = composite(raw_f, z_all, rays_d, nf, rcfg.white_bkgd)

    z_std = torch.std(z_samples, dim=-1, correction=0)
    return RenderResult(coarse=maps_c, fine=maps_f, z_std=z_std)


def _cat(parts):
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):  # a NamedTuple of maps
        return type(parts[0])(*(_cat(list(f)) for f in zip(*parts)))
    return torch.cat(parts)


def render_rays_chunked(
    model_coarse: MLP,
    model_fine: Optional[MLP],
    mlp_cfg: MLPConfig,
    rays: torch.Tensor,  # [M, 11]; any M
    rcfg: RenderConfig,
    chunk: int = 4096,
) -> RenderResult:
    """Eval-mode full-image render over chunks of ``chunk`` rays to bound
    device memory; the last chunk takes the rays that are left.  Eval rays
    are independent and the fused kernel masks a ragged tile, so no chunk
    is padded (the JAX package pads the last one to keep its shapes
    static).  Spans: ``render.enqueue`` over the call, one
    ``render.chunk`` (id: the chunk's index) a chunk."""
    with trace.span("render.enqueue"):
        outs = []
        for j, r in enumerate(torch.split(rays, chunk)):
            with trace.span("render.chunk", j):
                outs.append(render_rays(model_coarse, model_fine, mlp_cfg, r, rcfg, train=False))
        return _cat(outs)
