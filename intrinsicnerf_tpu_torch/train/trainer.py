"""Full-view rendering (the eval side of ``intrinsicnerf_tpu/train/trainer.py``).

``render_views`` is the serving path: every view of a ray pool is
rendered through ``render_rays_chunked`` and handed back as numpy maps.
It becomes a ``Trainer`` method when the trainer is ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.core.losses import semantic_entropy
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays_chunked


def _host(x: torch.Tensor, *shape) -> np.ndarray:
    if x.is_floating_point():
        x = x.float()
    return x.cpu().numpy().reshape(*shape)


def render_views(
    model_c: IntrinsicMLP,
    model_f: Optional[IntrinsicMLP],
    mcfg: MLPConfig,
    rcfg: RenderConfig,
    rays_all,  # [N, H*W, 11] tensor or array
    h: int,
    w: int,
    chunk: int,
    device="cuda",
) -> Iterator[Dict[str, np.ndarray]]:
    """Render every view in ``rays_all``; yields per-view dicts of numpy
    maps: rgb, disp, depth, acc, albedo, shading, residual and, with
    semantics, ``sem_label`` (argmax) and ``sem_entropy``.  The next
    view is queued on the device before the current one is copied to the
    host, so device and host work overlap.  The models must lie on
    ``device``; a missing GPU raises here, at the call, not at the
    first view."""
    rays_all = torch.as_tensor(rays_all, dtype=torch.float32, device=resolve_device(device))
    return _views(model_c, model_f, mcfg, rcfg, rays_all, h, w, chunk)


@torch.no_grad()
def _views(model_c, model_f, mcfg, rcfg, rays_all, h, w, chunk):
    def render(i):
        return render_rays_chunked(model_c, model_f, mcfg, rays_all[i], rcfg, chunk)

    n = rays_all.shape[0]
    pending = render(0) if n else None
    for i in range(n):
        out = pending
        if i + 1 < n:
            pending = render(i + 1)
        maps = out.fine if out.fine is not None else out.coarse
        view = {
            "rgb": _host(maps.rgb, h, w, 3),
            "disp": _host(maps.disp, h, w),
            "depth": _host(maps.depth, h, w),
            "acc": _host(maps.acc, h, w),
            "albedo": _host(maps.albedo, h, w, 3),
            "shading": _host(maps.shading, h, w),
            "residual": _host(maps.residual, h, w, 3),
        }
        if maps.sem_logits is not None:
            view["sem_label"] = _host(torch.argmax(maps.sem_logits, dim=-1), h, w)
            view["sem_entropy"] = _host(semantic_entropy(maps.sem_logits), h, w)
        if maps.endpoint_feat is not None:
            view["feat"] = _host(maps.endpoint_feat, h, w, -1)
        # reference parity: NaN/Inf alarm on every rendered map
        for k, v in view.items():
            if not np.isfinite(v).all():
                print(f"! [Numerical Error] view {i} map '{k}' contains nan or inf.")
        yield view
