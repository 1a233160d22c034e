"""Image, semantic and intrinsic-decomposition losses.

Port of ``intrinsicnerf_tpu/core/losses.py``.  Pairing contract: a
training batch of ``2N`` rays is ``[originals(N), neighbours(N)]``, so
``batch[i]`` and ``batch[i + N]`` are an 8-neighbourhood pixel pair; the
"far" loss pairs the first and the last quarter of the originals.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def chromaticity(color: torch.Tensor, eps: float = 1e-5):
    """(r, g) chromaticity: ``r = R/(R+G+B+eps)``, ``g = G/(...)``."""
    s = torch.sum(color, dim=-1) + eps
    return color[..., 0] / s, color[..., 1] / s


def chroma_loss(color1: torch.Tensor, color2: torch.Tensor) -> torch.Tensor:
    """Mean squared chromaticity difference (albedo vs gt rgb)."""
    r1, g1 = chromaticity(color1)
    r2, g2 = chromaticity(color2)
    return torch.mean((r1 - r2) ** 2) + torch.mean((g1 - g2) ** 2)


def residual_loss(residual: torch.Tensor) -> torch.Tensor:
    return torch.mean(residual**2)


def chroma_pair_weights(color1, color2, same_mask):
    """``(exp(-60 d2) * same_mask, d2)`` from the gt chromaticity
    difference ``d2`` of each pair: the first drives reflectance sparsity,
    the second shading smoothness."""
    r1, g1 = chromaticity(color1)
    r2, g2 = chromaticity(color2)
    d2 = (r1 - r2) ** 2 + (g1 - g2) ** 2
    return torch.exp(-60.0 * d2) * same_mask, d2


def chroma_pair_weights_masked(color1, color2, mask1, mask2):
    """Object-level variant: both weights gated by the object-mask product."""
    r1, g1 = chromaticity(color1)
    r2, g2 = chromaticity(color2)
    d2 = (r1 - r2) ** 2 + (g1 - g2) ** 2
    m = mask1 * mask2
    return torch.exp(-60.0 * d2) * m, d2 * m


def reflect_sparsity_loss(albedo1, albedo2, w):
    return torch.mean(w * torch.sum((albedo1 - albedo2) ** 2, dim=-1))


def shading_smooth_loss(shading1, shading2, inv_w):
    return torch.mean(inv_w * (shading1 - shading2) ** 2)


def intensity_loss(gt_rgb, albedo):
    return (torch.mean(gt_rgb) - torch.mean(albedo)) ** 2


class IntrinsicLosses(NamedTuple):
    chroma: torch.Tensor
    residual: torch.Tensor
    reflect_sparsity: torch.Tensor
    shading_smooth: torch.Tensor
    far_reflect: torch.Tensor
    intensity: torch.Tensor


def compute_intrinsic_losses(
    albedo: torch.Tensor,  # [2N, 3]
    shading: torch.Tensor,  # [2N]
    residual: torch.Tensor,  # [2N, 3]
    gt_rgb: torch.Tensor,  # [2N, 3]
    pair_label: torch.Tensor,  # [2N] semantic label (scene) or object mask (object)
    mask_mode: str = "label",  # "label": same-label indicator; "mask": mask product
) -> IntrinsicLosses:
    """All six intrinsic-prior losses on a neighbour-paired batch,
    including the quarter-split far pairs (originals[:N/2] vs the last
    N/2 originals)."""
    n = albedo.shape[0] // 2
    a1, a2 = albedo[:n], albedo[-n:]
    s1, s2 = shading[:n], shading[-n:]
    c1, c2 = gt_rgb[:n], gt_rgb[-n:]
    l1, l2 = pair_label[:n], pair_label[-n:]

    li = intensity_loss(gt_rgb, albedo)
    lr = residual_loss(residual)
    lc = chroma_loss(albedo, gt_rgb)

    if mask_mode == "label":
        w, inv_w = chroma_pair_weights(c1, c2, (l1 == l2).to(albedo.dtype))
    else:
        w, inv_w = chroma_pair_weights_masked(c1, c2, l1, l2)
    lsp = reflect_sparsity_loss(a1, a2, w)
    lsm = shading_smooth_loss(s1, s2, inv_w)

    m = n // 2  # far pairs: non-adjacent originals
    if mask_mode == "label":
        w_far, _ = chroma_pair_weights(c1[:m], c1[-m:], (l1[:m] == l1[-m:]).to(albedo.dtype))
    else:
        w_far, _ = chroma_pair_weights_masked(c1[:m], c1[-m:], l1[:m], l1[-m:])
    lfar = reflect_sparsity_loss(a1[:m], a1[-m:], w_far)

    return IntrinsicLosses(
        chroma=lc,
        residual=lr,
        reflect_sparsity=lsp,
        shading_smooth=lsm,
        far_reflect=lfar,
        intensity=li,
    )


def semantic_cross_entropy(
    logits: torch.Tensor,  # [N, C] composited semantic logits
    labels: torch.Tensor,  # [N] raw labels; 0 = void
    void_shift: bool = True,
) -> torch.Tensor:
    """``CE(logits, label - 1, ignore -1)``: the mean over non-void rays,
    and 0 (where ``nn.CrossEntropyLoss(ignore_index=-1)`` gives NaN) when
    every label is void."""
    tgt = labels.long() - 1 if void_shift else labels.long()
    valid = tgt >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(tgt, min=0)[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = torch.sum(valid)
    return torch.sum(nll) / torch.clamp(count, min=1)


def semantic_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-ray predictive entropy (uncertainty) over the class axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(-logp * torch.exp(logp), dim=-1)
