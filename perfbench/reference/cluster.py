"""The plain reference of a reflectance-cluster rebuild and of its table.

From the published description (IntrinsicNeRF's reflectance clustering,
with scikit-learn's ``estimate_bandwidth`` and ``MeanShift``), in plain
PyTorch at float64; it imports nothing of the program.

- the rebuild renders its views at every second row and column, with
  evenly spaced samples and no noise, and takes each pixel's albedo and,
  with semantics, its argmax class (else class 0);
- per class, the albedo maps to ``d = [I/3 * 0.5, g/I, b/I]`` with
  ``I = r + g + b`` (pixels with ``I = 0`` dropped); the bandwidth is
  the mean distance to the ``int(0.3 m)``-th nearest neighbour (itself
  included) over ``m`` = 5,000 points drawn by
  ``numpy.random.RandomState(0).permutation``, times the rebuild's band
  factor, and at least 0.01;
- flat-kernel mean-shift seeded at the occupied bins of side the
  bandwidth: each seed moves to the mean of the points within the
  bandwidth until it moves less than a thousandth of it (300 moves at
  most); seeds with points are ranked by that count (then by their
  coordinates, descending), and each drops every lower-ranked one
  within the bandwidth; every point joins its nearest centre;
- the anchors: per occupied voxel of side 0.01 in ``d``, the point
  nearest the voxel's centre, with its cluster; a cluster's colour is
  its centre mapped back to rgb, clipped to [0, 1];
- the table the step reads: per class, its anchors and each anchor's
  cluster colour; a pixel's target is the colour of the nearest anchor
  of its class (``lookup``), or its own colour where the class has none.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import nerf

LEAF = 0.01
PAD = 1.0e6
QUANTILE = 0.3
SAMPLES = 5000
INTENSITY_FACTOR = 0.5


def to_d(rgb: torch.Tensor) -> torch.Tensor:
    i = rgb.sum(-1)
    return torch.stack([i / 3.0 * INTENSITY_FACTOR, rgb[..., 1] / i, rgb[..., 2] / i], -1)


def from_d(d: torch.Tensor) -> torch.Tensor:
    i = d[..., 0] * 3.0 / INTENSITY_FACTOR
    g, b = d[..., 1] * i, d[..., 2] * i
    return torch.stack([i - g - b, g, b], -1)


def _d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[len(a), len(b)]`` (float64 keeps the expansion
    exact enough at these scales)."""
    return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * a @ b.T).clamp(min=0.0)


def bandwidth(x: torch.Tensor) -> float:
    """scikit-learn's ``estimate_bandwidth(x, quantile=0.3, n_samples=5000,
    random_state=0)``."""
    if x.shape[0] > SAMPLES:
        idx = np.random.RandomState(0).permutation(x.shape[0])[:SAMPLES]
        x = x[torch.as_tensor(idx, device=x.device)]
    k = max(1, int(x.shape[0] * QUANTILE))
    total = 0.0
    for rows in torch.split(x, 1024):
        total += float(_d2(rows, x).topk(k, -1, largest=False).values[:, -1].sqrt().sum())
    return total / x.shape[0]


def mean_shift(x: torch.Tensor, bw: float, max_iter: int = 300):
    """(centres [K, 3], each point's centre [N]) of scikit-learn's
    ``MeanShift(bandwidth=bw, bin_seeding=True)``."""
    bins = torch.unique(torch.round(x / bw), dim=0)
    seeds = x.clone() if len(bins) == len(x) else bins * bw
    bw2 = bw * bw
    mean = seeds.clone()
    count = torch.zeros(len(seeds), dtype=torch.long, device=x.device)
    active = torch.ones(len(seeds), dtype=torch.bool, device=x.device)
    for _ in range(max_iter + 1):
        live = active.nonzero()[:, 0]
        if len(live) == 0:
            break
        for idx in torch.split(live, 128):
            within = (_d2(mean[idx], x) <= bw2).to(x.dtype)
            n = within.sum(-1)
            count[idx] = n.long()
            empty = n == 0
            new = (within @ x) / n.clamp(min=1)[:, None]
            moved = (new - mean[idx]).norm(dim=-1)
            mean[idx[~empty]] = new[~empty]
            active[idx[empty | (moved < 1e-3 * bw)]] = False
    keep = count > 0
    centres, count = mean[keep], count[keep]
    order = sorted(range(len(centres)), key=lambda i: (int(count[i]), *centres[i].tolist()),
                   reverse=True)
    centres = centres[order]
    unique = torch.ones(len(centres), dtype=torch.bool, device=x.device)
    near = _d2(centres, centres) <= bw2
    for i in range(len(centres)):
        if unique[i]:
            unique[near[i]] = False
            unique[i] = True
    centres = centres[unique]
    label = torch.cat([_d2(rows, centres).argmin(-1) for rows in torch.split(x, 65536)])
    return centres, label


def voxel_anchors(d: torch.Tensor, label: torch.Tensor):
    """(anchors [A, 3], their cluster [A]): per occupied voxel, the point
    nearest its centre."""
    grid = round(1.0 / LEAF)
    ids = (d / LEAF).floor().long().clamp(0, grid - 1)
    dist = ((ids.to(d.dtype) * LEAF + LEAF / 2 - d) ** 2).sum(-1)
    flat = (ids[:, 0] * grid + ids[:, 1]) * grid + ids[:, 2]
    order = torch.argsort(dist, stable=True)
    _, inverse = torch.unique(flat[order], return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), len(order), dtype=torch.long, device=d.device)
    first.scatter_reduce_(0, inverse, torch.arange(len(order), device=d.device), "amin")
    pick = order[first]
    return d[pick], label[pick]


def build_class(rgb: torch.Tensor, band_factor: float):
    """(anchors [A, 3] in ``d``, their colours [A, 3]) of one class's albedo."""
    d = to_d(rgb.double())
    d = d[torch.isfinite(d).all(-1)]
    if len(d) == 0:
        d = torch.zeros(1, 3, dtype=torch.float64, device=rgb.device)
    bw = max(bandwidth(d) * band_factor, 0.01)
    centres, label = mean_shift(d, bw)
    anchors, links = voxel_anchors(d, label)
    colours = from_d(centres).clamp(0.0, 1.0)
    return anchors, colours[links]


def table(per_class: List[Optional[tuple]], device) -> dict:
    """The table ``lookup`` reads: anchors padded with a far
    point, their colours, and which classes have clusters."""
    a = max([1] + [len(e[0]) for e in per_class if e is not None])
    c = len(per_class)
    anchors = torch.full((c, a, 3), PAD, dtype=torch.float32, device=device)
    colours = torch.zeros(c, a, 3, dtype=torch.float32, device=device)
    has = torch.zeros(c, dtype=torch.bool, device=device)
    for i, entry in enumerate(per_class):
        if entry is not None:
            anchors[i, :len(entry[0])] = entry[0].float()
            colours[i, :len(entry[1])] = entry[1].float()
            has[i] = True
    return {"anchors": anchors, "colors": colours, "has_cluster": has,
            "intensity_factor": INTENSITY_FACTOR}


def lookup(table: dict, rgb: torch.Tensor, label: torch.Tensor, block: int = 8192):
    """(the colour of each pixel's nearest anchor of its class [P, 3],
    whether its class has clusters [P]) in ``table``."""
    label = label.clamp(0, table["anchors"].shape[0] - 1)
    f = table["intensity_factor"]
    out = []
    for rows, cls in zip(torch.split(rgb.float(), block), torch.split(label, block)):
        i = rows.sum(-1)
        d = torch.stack([i / 3.0 * f, rows[:, 1] / i, rows[:, 2] / i], -1)
        dist = ((table["anchors"][cls] - d[:, None]) ** 2).sum(-1)
        best = dist.argmin(-1)
        out.append(table["colors"][cls, best])
    return torch.cat(out), table["has_cluster"][label]


def rebuild_pixels(weights: Dict[str, Dict[str, torch.Tensor]], arch: dict, rays: torch.Tensor,
                   h: int, w: int, precision: str = "float32"):
    """(albedo [P, 3], class [P]) of the rebuild's views ``rays [V, H*W,
    11]`` at every second row and column."""
    sub = rays.reshape(rays.shape[0], h, w, -1)[:, ::2, ::2].reshape(-1, rays.shape[-1])
    maps = nerf.render_view(weights["coarse"], weights.get("fine"), arch, sub,
                            precision=precision)
    label = (maps["sem"].argmax(-1) if "sem" in maps
             else torch.zeros(len(sub), dtype=torch.long, device=sub.device))
    return maps["albedo"], label


def rebuild(albedo: torch.Tensor, label: torch.Tensor, n_classes: int, band_factor: float) -> dict:
    """The table of a rebuild over ``albedo`` of classes ``label``."""
    per_class = []
    for c in range(n_classes):
        pick = label == c
        per_class.append(build_class(albedo[pick], band_factor) if bool(pick.any()) else None)
    return table(per_class, albedo.device)
