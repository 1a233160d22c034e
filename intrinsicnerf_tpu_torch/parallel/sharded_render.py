"""Full-image renders split over the data-parallel group.

Port of ``intrinsicnerf_tpu/parallel/sharded_render.py``: the ray axis of
a view is split over the ranks, each rank renders its contiguous slice
with ``render_rays_chunked``, and every rank gathers the whole view (the
JAX ``replicate_output=True`` path, the only one with one process per
device: every process needs whole views for the cluster rebuild's
mean-shift, the metrics and the image writes).  Per-ray work never
crosses ranks; the gather is the one collective.
"""

from __future__ import annotations

import torch

from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
from intrinsicnerf_tpu_torch.parallel.mesh import DataGroup, all_gather_rows
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays_chunked


def _gathered(group: DataGroup, out, n_rays: int):
    """``out`` (a ``RenderResult`` or a field of it) with every tensor
    gathered over the group and cut back to ``n_rays`` rows."""
    if out is None:
        return None
    if isinstance(out, tuple):
        return type(out)(*(_gathered(group, x, n_rays) for x in out))
    return all_gather_rows(group, out)[:n_rays]


def make_sharded_render(mcfg: MLPConfig, rcfg: RenderConfig, group: DataGroup, n_rays: int,
                        chunk: int = 4096):
    """``render(model_coarse, model_fine, rays [n_rays, 11]) ->
    RenderResult`` of the whole view on every rank.  The ray count is
    padded to a multiple of the world size by repeating the last ray;
    rank ``r`` renders rays ``[r, r + 1) * n_padded / world`` in chunks of
    ``min(chunk, local count)`` (the last one short, as the port chunks);
    the outputs are gathered and cut back to ``n_rays``.  At world 1 this
    is ``render_rays_chunked`` at that chunk."""
    pad = (-n_rays) % group.world
    local = (n_rays + pad) // group.world
    local_chunk = min(chunk, local)

    def render(model_coarse, model_fine, rays):
        if rays.shape[0] != n_rays:
            raise ValueError(f"the sharded render was made for {n_rays} rays, got {rays.shape[0]}")
        if pad:
            rays = torch.cat([rays, rays[-1:].expand(pad, rays.shape[-1])])
        mine = rays[group.rank * local:(group.rank + 1) * local]
        out = render_rays_chunked(model_coarse, model_fine, mcfg, mine, rcfg, local_chunk)
        return _gathered(group, out, n_rays)

    return render

