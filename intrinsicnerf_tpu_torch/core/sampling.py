"""Stratified and hierarchical (inverse-CDF) depth sampling.

Port of ``intrinsicnerf_tpu/core/sampling.py``.  The JAX module avoids
gathers (a one-hot mask-reduce for the bin-edge lookup, a dense rank
merge of the coarse and importance depths) because per-element gathers
serialize on a TPU.  On the GPU a gather is cheap and the rank merge's
``[N, 192, 192]`` temporary would be 4.8 GB at a 32,768-ray chunk, so
this module uses ``torch.searchsorted`` / ``torch.gather`` and a sort,
which give identical values.

Random draws are injected (``t_rand``, ``u``), never generated here, so
both packages can be fed the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch


def _linspace01(n: int, like: torch.Tensor) -> torch.Tensor:
    """``linspace(0, 1, n)`` rounded as the JAX package's is: ``i * fl(1/(n-1))``.
    ``torch.linspace`` puts some points an ulp away, which the ``lindisp``
    reciprocal and the inverse CDF amplify to ~1e-5."""
    return torch.arange(n, dtype=like.dtype, device=like.device) * (1.0 / max(n - 1, 1))


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    lindisp: bool = False,
) -> torch.Tensor:
    """Linear-in-depth (or in-disparity) samples; near/far ``[N, 1]``."""
    t = _linspace01(n_samples, near)
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


def perturb_z_vals(z_vals: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """Jitter each sample within its interval by the uniforms ``t_rand``
    (same shape as ``z_vals``), as the reference's mids/upper/lower do."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def sorted_uniforms(shape, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Sorted U(0, 1) draws ``[..., n]`` without a sort: the running sum
    of n+1 iid Exp(1) draws, normalised by the total, is distributed as
    the order statistics of n iid uniforms.  Sorted ``u`` keeps the
    importance depths of ``sample_pdf`` sorted, as in the JAX package."""
    *lead, n = shape
    e = -torch.log1p(-torch.rand(*lead, n + 1, generator=generator, device=device, dtype=dtype))
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Draw ``n_samples`` per ray from the piecewise-constant pdf.

    bins ``[N, B]`` sorted edges, weights ``[N, B-1]``.  ``u`` (``[N,
    n_samples]``) supplies the uniforms; with ``det=True`` and no ``u``
    they are ``linspace(0, 1)``.  Callers detach the result."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

    if u is None:
        if not det:
            raise ValueError("sample_pdf: pass the uniforms u= when det=False")
        u = _linspace01(n_samples, cdf).expand(*cdf.shape[:-1], n_samples)
    u = u.contiguous()

    # side='right' == number of cdf entries <= u; the cdf is a cumsum of
    # positive terms, hence sorted, as searchsorted requires
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_z_vals(z_vals: torch.Tensor, z_samples: torch.Tensor) -> torch.Tensor:
    """Sorted union of two depth arrays along the last axis.  Exact for
    any inputs, so it also stands in for the JAX ``merge_sorted_z_vals``
    (whose rank merge needs sorted operands)."""
    return torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
