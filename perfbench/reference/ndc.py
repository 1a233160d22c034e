"""The plain reference of a forward-facing (LLFF) training step in NDC.

From nerf-pytorch's forward-facing path, in plain PyTorch at float32; it
imports nothing of the program.  A step is ``train.step``'s with the
rays of the pose sampler projected to normalised device coordinates:

- the draws of ``train.draw_pixels`` (the image, the pixels anywhere in
  the frame: no centre crop; the neighbour offsets), in the program's
  order, then those of ``train.draw_render``;
- the rays of ``train.batch``: the pixel directions rotated by the
  image's pose, the camera centre as origin, and the unit view
  direction taken from the world direction, before any projection;
- nerf-pytorch's ``ndc_rays`` with near plane 1: each origin shifted
  along its ray to ``z = -1`` (``t = -(1 + o_z) / d_z``), then
  ``o' = (-f/(W/2) o_x/o_z, -f/(H/2) o_y/o_z, 1 + 2/o_z)`` and
  ``d' = (-f/(W/2) (d_x/d_z - o_x/o_z), -f/(H/2) (d_y/d_z - o_y/o_z),
  -2/o_z)``; the rays march from 0 to 1;
- the render, the losses and Adam of ``train.py``.

``focal`` None leaves the projection out (the world rays, with the
dataset's near and far), a fault the comparison has to catch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import nerf
from perfbench.reference import train as rtrain


def ndc_rays(h: int, w: int, focal: float, near: float, rays_o, rays_d):
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def project(rays: torch.Tensor, h: int, w: int, focal: Optional[float]) -> torch.Tensor:
    """World rays ``[..., 11]`` in NDC: origin and direction projected,
    near 0 and far 1, the view direction kept; unchanged without a
    ``focal``."""
    if focal is None:
        return rays
    o, d = ndc_rays(h, w, focal, 1.0, rays[..., 0:3], rays[..., 3:6])
    nf = torch.tensor([0.0, 1.0], device=rays.device).expand(*rays.shape[:-1], 2)
    return torch.cat([o, d, nf, rays[..., 8:11]], -1)


def batch(data: dict, hp: dict, focal: Optional[float], img, rows, cols, bh, bw) -> dict:
    """The paired rays of the draws, in NDC, and their ground truth."""
    b = rtrain.batch(data, hp, img, rows, cols, bh, bw)
    return dict(b, rays=project(b["rays"], hp["h"], hp["w"], focal))


def draw_batch(gen: torch.Generator, data: dict, hp: dict, focal: Optional[float], step: int):
    """One draw of the pose sampler from ``gen`` and its batch."""
    picks = rtrain.draw_pixels(gen, hp, data["rgb"].shape[0], step, data["rgb"].device)
    return batch(data, hp, focal, *picks)


def step(params: Dict[str, Dict[str, torch.Tensor]], opt: rtrain.Adam, data: dict, gen,
         arch: dict, hp: dict, focal: Optional[float], table: Optional[dict], w_c: float,
         step_count: int, precision: str = "float32", fault: Optional[str] = None):
    """``train.step`` on NDC rays (the same draws, losses, faults and
    update)."""
    device = data["rgb"].device
    b = draw_batch(gen, data, hp, focal, step_count)
    draws = rtrain.draw_render(gen, arch, b["rays"].shape[0], device)
    if fault == "half_batch":
        n = hp["n_rays"]
        keep = torch.cat([torch.arange(0, n // 2), torch.arange(n, n + n // 2)]).to(device)
        b = {k: (v[keep] if v.dim() else v) for k, v in b.items()}
        draws = {k: (v[keep] if v is not None else None) for k, v in draws.items()}
    leaves = {lvl: {k: v.detach().requires_grad_(True) for k, v in p.items()}
              for lvl, p in params.items()}
    coarse, fine = nerf.render(leaves["coarse"], leaves.get("fine"), arch, b["rays"], draws,
                               precision)
    last = fine if fine is not None else coarse
    target = None
    if table is not None:
        with torch.no_grad():
            cls = torch.zeros(last["albedo"].shape[0], dtype=torch.long, device=device)
            target = rtrain.nearest_colour(table, last["albedo"].detach(), cls)
    w_res = hp["w_res1"] if step_count <= hp["residual_switch"] else hp["w_res2"]
    w_i = hp["w_i1"] if step_count <= hp["intensity_switch"] else hp["w_i2"]
    terms = [rtrain.level_loss(m, b, hp, w_res, w_i, target, w_c)
             for m in (coarse, fine) if m is not None]
    total = sum(t["total"] for t in terms)
    flat = [v for lvl in leaves for v in leaves[lvl].values()]
    gflat = torch.autograd.grad(total, flat, allow_unused=True)
    grads, i = {}, 0
    for lvl, p in leaves.items():
        grads[lvl] = {}
        for k, v in p.items():
            grads[lvl][k] = torch.zeros_like(v) if gflat[i] is None else gflat[i].detach()
            i += 1
    if fault != "unchanged":
        opt.update({f"{lvl}/{k}": params[lvl][k] for lvl in params for k in params[lvl]},
                   {f"{lvl}/{k}": grads[lvl][k] for lvl in grads for k in grads[lvl]},
                   step_count)
    return {"total": total.detach()}, grads


def follow(init: Dict[str, Dict[str, torch.Tensor]], data: dict, seed: int, n_steps: int,
           arch: dict, hp: dict, focal: Optional[float], table: Optional[dict], w_c: float,
           observe=(), precision: str = "float32", fault: Optional[str] = None):
    """``train.follow`` on NDC rays: the total loss after each step in
    ``observe``, the first of those steps' gradients, and the parameters
    after ``n_steps``."""
    params = {lvl: {k: v.detach().clone().float() for k, v in p.items()}
              for lvl, p in init.items()}
    opt = rtrain.Adam({f"{lvl}/{k}": v for lvl in params for k, v in params[lvl].items()}, hp)
    gen = torch.Generator(device=data["rgb"].device).manual_seed(seed)
    losses, first_grads = {}, None
    for s in range(n_steps):
        terms, grads = step(params, opt, data, gen, arch, hp, focal, table, w_c, s, precision,
                            fault)
        if s + 1 in observe:
            losses[s + 1] = float(terms["total"])
            if first_grads is None:
                first_grads = grads
    return losses, first_grads, params


def ray_gap(prog, ref) -> float:
    """``prog``, ``ref``: (rays [2N, 11], colours [2N, 3], masks [2N]) of
    one draw.  The worst gap of the origins, of the directions and of the
    view directions, each over the reference's RMS of that block, plus 1
    where any pair's colour or mask differs; a draw of another size reads
    2, as one whose rays and colours are all off."""
    if any(p.shape != r.shape for p, r in zip(prog, ref)):
        return 2.0
    gaps = []
    for lo, hi in ((0, 3), (3, 6), (8, 11)):
        p, r = prog[0][:, lo:hi].double(), ref[0][:, lo:hi].double()
        gaps.append(float((p - r).abs().max() / r.pow(2).mean().sqrt().clamp(min=1e-30)))
    differs = bool(((prog[1] != ref[1]).any(-1) | (prog[2] != ref[2])).any())
    return max(gaps) + float(differs)
