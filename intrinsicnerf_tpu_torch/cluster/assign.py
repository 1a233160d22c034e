"""Reflectance-cluster assignment over padded anchor tables.

Port of ``intrinsicnerf_tpu/cluster/assign.py``: map rgb to ``d_rgb =
[I/3 * intensity_factor, g/I, b/I]``, find the nearest anchor of the
point's semantic class in that space, and return the anchor's
cluster-centre colour.  The per-class anchor sets live in one padded
table ``[C, A, 3]`` (pads at +1e6 never win the argmin); classes without
clusters keep the input colour.  ``argmin`` ties take the first index,
as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device

PAD_VALUE = 1.0e6


class ClusterTable(NamedTuple):
    """Padded cluster tables for ``C`` semantic classes, on one device."""

    anchors: torch.Tensor  # [C, A, 3] d_rgb anchors, PAD_VALUE padded
    colors: torch.Tensor  # [C, A, 3] rgb centre colour linked to each anchor
    links: torch.Tensor  # [C, A] int32 cluster id of each anchor (-1 pad)
    has_cluster: torch.Tensor  # [C] bool: the class has any anchors
    intensity_factor: float


def map_drgb(rgb, intensity_factor=0.5):
    """rgb -> (intensity/3 * f, g/I, b/I) chroma/intensity space (torch or numpy)."""
    stack = torch.stack if isinstance(rgb, torch.Tensor) else np.stack
    intensity = rgb.sum(-1)
    return stack(
        [intensity / 3.0 * intensity_factor, rgb[..., 1] / intensity, rgb[..., 2] / intensity],
        -1,
    )


def inv_map_drgb(d_rgb, intensity_factor=0.5):
    stack = torch.stack if isinstance(d_rgb, torch.Tensor) else np.stack
    intensity = d_rgb[..., 0] * 3.0 / intensity_factor
    g = d_rgb[..., 1] * intensity
    b = d_rgb[..., 2] * intensity
    return stack([intensity - g - b, g, b], -1)


def empty_cluster_table(num_classes: int, anchors_per_class: int = 2048,
                        device="cuda") -> ClusterTable:
    """All-pad table: assignment falls back to the input colour."""
    dev = resolve_device(device)
    c, a = num_classes, anchors_per_class
    return ClusterTable(
        anchors=torch.full((c, a, 3), PAD_VALUE, dtype=torch.float32, device=dev),
        colors=torch.zeros((c, a, 3), dtype=torch.float32, device=dev),
        links=torch.full((c, a), -1, dtype=torch.int32, device=dev),
        has_cluster=torch.zeros((c,), dtype=torch.bool, device=dev),
        intensity_factor=0.5,
    )


def _nearest_anchor_idx(table: ClusterTable, rgb: torch.Tensor, label: torch.Tensor):
    d = map_drgb(rgb, table.intensity_factor)  # [N, 3]
    label = torch.clamp(label.reshape(-1).long(), 0, table.anchors.shape[0] - 1)
    anchors = table.anchors[label]  # [N, A, 3] per-point class table
    # ||d - a||^2 up to the constant |d|^2: argmin over |a|^2 - 2 d.a
    score = torch.sum(anchors * anchors, dim=-1) - 2.0 * torch.einsum("nd,nad->na", d, anchors)
    return torch.argmin(score, dim=-1), label


def dest_color(table: ClusterTable, rgb: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Each rgb ``[N, 3]`` mapped to its cluster-centre colour (the input
    colour where the point's class has no clusters); label ``[N]``.  The
    winner's colour is one flat row gather ``colors[label * A + idx]``."""
    idx, label = _nearest_anchor_idx(table, rgb, label)
    a = table.colors.shape[1]
    out = table.colors.reshape(-1, 3)[label * a + idx]
    return torch.where(table.has_cluster[label][:, None], out, rgb)


def dest_class(table: ClusterTable, rgb: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Cluster id per point (-1 where the class has no clusters)."""
    idx, label = _nearest_anchor_idx(table, rgb, label)
    a = table.links.shape[1]
    link = table.links.reshape(-1)[label * a + idx]
    return torch.where(table.has_cluster[label], link, torch.full_like(link, -1))


def table_from_numpy(per_class: list, anchors_per_class: int = 2048,
                     intensity_factor: float = 0.5, device="cuda") -> ClusterTable:
    """A padded table from per-class host data on ``device``.

    ``per_class[i]`` is None (no clusters) or ``(anchors_drgb [A_i, 3],
    links [A_i], rgb_centers [K_i, 3])``.  A class with more anchors than
    the pad size keeps the ``A`` anchors nearest their own cluster centre
    (stable order), and the truncation is printed."""
    dev = resolve_device(device)
    c, a = len(per_class), anchors_per_class
    anchors = np.full((c, a, 3), PAD_VALUE, np.float32)
    colors = np.zeros((c, a, 3), np.float32)
    links = np.full((c, a), -1, np.int32)
    has = np.zeros((c,), bool)
    for i, entry in enumerate(per_class):
        if entry is None:
            continue
        anc, lnk, centers = entry
        anc = np.asarray(anc, np.float32)
        lnk = np.asarray(lnk, np.int64).reshape(-1)
        centers = np.asarray(centers, np.float32)
        if len(anc) > a:
            centers_d = map_drgb(centers, np.float32(intensity_factor)).astype(np.float32)
            lnk_safe = np.clip(lnk, 0, len(centers) - 1)
            dist = np.linalg.norm(anc - centers_d[lnk_safe], axis=1)
            keep = np.argsort(dist, kind="stable")[:a]
            print(f"[cluster] class {i}: truncating {len(anc)} anchors to "
                  f"{a} (nearest-to-center kept)")
            anc, lnk = anc[keep], lnk[keep]
        m = len(anc)
        anchors[i, :m] = anc
        links[i, :m] = lnk
        colors[i, :m] = centers[np.clip(lnk, 0, len(centers) - 1)]
        has[i] = m > 0
    return ClusterTable(
        anchors=torch.from_numpy(anchors).to(dev),
        colors=torch.from_numpy(colors).to(dev),
        links=torch.from_numpy(links).to(dev),
        has_cluster=torch.from_numpy(has).to(dev),
        intensity_factor=float(np.float32(intensity_factor)),
    )
