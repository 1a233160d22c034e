"""Reflectance cluster construction and persistence (host side).

The port's copy of ``intrinsicnerf_tpu/cluster/manager.py``:

- per semantic class, the rendered-albedo pixels are clustered in the
  ``d_rgb = [I/3*0.5, g/I, b/I]`` space with bandwidth
  ``max(estimate_bandwidth(q=0.3, n=5000) * band_factor, 0.01)`` by
  flat-kernel mean-shift with bin seeding;
- the anchors are one representative pixel per occupied voxel of a 100^3
  grid at leaf 0.01, the pixel nearest the voxel centre winning;
- the palette persists as ``clusters.json`` plus ``c{i}/config.json``
  (batch_size, intensity_factor, rgb_centers, anchors, links) and 50x50
  colour swatches, the JAX package's (and the original's) layout, so the
  JAX ``ClusterManager.load``, ``gui.py`` and the editing tools read a
  port palette unchanged, and the port reads theirs.

``ClusterManager.to_table`` puts the palette on the device through
:func:`intrinsicnerf_tpu_torch.cluster.assign.table_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from intrinsicnerf_tpu_torch.cluster.assign import ClusterTable, table_from_numpy
from intrinsicnerf_tpu_torch.cluster.meanshift import estimate_bandwidth, mean_shift
from intrinsicnerf_tpu_torch.utils.image import imwrite

LEAF_SIZE = 0.01
GRID = int(1 / LEAF_SIZE)


def map_drgb_np(rgb: np.ndarray, intensity_factor: float = 0.5) -> np.ndarray:
    """rgb -> d_rgb; zero-intensity pixels map to NaN (no 0/0 warning), so
    ``build_cluster`` drops them."""
    intensity = rgb.sum(-1)
    out = np.empty_like(rgb)
    out[..., 0] = intensity / 3.0 * intensity_factor
    pos = intensity > 0
    safe = np.where(pos, intensity, 1.0)
    out[..., 1] = np.where(pos, rgb[..., 1] / safe, np.nan)
    out[..., 2] = np.where(pos, rgb[..., 2] / safe, np.nan)
    return out


def inv_map_drgb_np(d: np.ndarray, intensity_factor: float = 0.5) -> np.ndarray:
    intensity = d[..., 0] * 3.0 / intensity_factor
    out = np.empty_like(d)
    out[..., 1] = d[..., 1] * intensity
    out[..., 2] = d[..., 2] * intensity
    out[..., 0] = intensity - out[..., 1] - out[..., 2]
    return out


def voxel_anchor_filter(pixels_drgb: np.ndarray, labels: np.ndarray):
    """One representative pixel and cluster label per occupied 0.01 voxel;
    the pixel nearest its voxel centre wins (written last)."""
    ids = np.clip((pixels_drgb / LEAF_SIZE).astype(np.int64), 0, GRID - 1)
    centers = ids * LEAF_SIZE + LEAF_SIZE / 2
    dist = np.sum((centers - pixels_drgb) ** 2, axis=1)
    order = np.argsort(-dist, kind="stable")
    flat = (ids[order, 0] * GRID + ids[order, 1]) * GRID + ids[order, 2]
    vox_pix = np.zeros((GRID**3, 3), np.float32)
    vox_lab = np.full((GRID**3,), -1, np.int64)
    vox_pix[flat] = pixels_drgb[order]
    vox_lab[flat] = labels[order]
    occupied = vox_lab >= 0
    return vox_pix[occupied], vox_lab[occupied]


@dataclasses.dataclass
class Cluster:
    """One class's clusters: voxel anchors (d_rgb) -> cluster id -> colour."""

    anchors: np.ndarray  # [A, 3] d_rgb
    links: np.ndarray  # [A] cluster id per anchor
    rgb_centers: np.ndarray  # [K, 3] rgb colour per cluster
    intensity_factor: float = 0.5
    batch_size: int = 10240  # kept for config-file compatibility

    def save(self, cluster_dir: str):
        os.makedirs(cluster_dir, exist_ok=True)
        data = {
            "batch_size": self.batch_size,
            "intensity_factor": self.intensity_factor,
            "rgb_centers": np.asarray(self.rgb_centers, np.float64).tolist(),
            "anchors": np.asarray(self.anchors, np.float64).tolist(),
            "links": np.asarray(self.links, np.float64).reshape(-1, 1).tolist(),
        }
        with open(os.path.join(cluster_dir, "config.json"), "w") as f:
            json.dump(data, f)
        for i, color in enumerate(np.asarray(self.rgb_centers)):
            swatch = (np.clip(color, 0, 1) * np.ones((50, 50, 3)) * 255).astype(np.uint8)
            imwrite(os.path.join(cluster_dir, f"{i}.png"), swatch)

    @classmethod
    def load(cls, cluster_dir: str) -> "Cluster":
        with open(os.path.join(cluster_dir, "config.json")) as f:
            data = json.load(f)
        return cls(
            anchors=np.asarray(data["anchors"], np.float32),
            links=np.asarray(data["links"], np.int64).reshape(-1),
            rgb_centers=np.asarray(data["rgb_centers"], np.float32),
            intensity_factor=float(data["intensity_factor"]),
            batch_size=int(data["batch_size"]),
        )


def build_cluster(pixels_rgb: np.ndarray, quantile: float = 0.3, n_samples: int = 5000,
                  band_factor: float = 0.5, intensity_factor: float = 0.5) -> Cluster:
    """Cluster one class's albedo pixels.  Pixels with a non-finite d_rgb
    (all-zero albedo: an empty ray) are dropped, since one NaN anchor would
    poison every cluster target."""
    d = map_drgb_np(np.asarray(pixels_rgb, np.float64), intensity_factor)
    finite = np.isfinite(d).all(axis=1)
    if not finite.all():
        d = d[finite]
    if len(d) == 0:  # every pixel empty: one black pseudo-cluster
        d = np.zeros((1, 3), np.float64)
    bw = estimate_bandwidth(d, quantile=quantile, n_samples=n_samples)
    bw = max(bw * band_factor, 0.01)
    centers_d, labels = mean_shift(d, bw, bin_seeding=True)
    anchors, links = voxel_anchor_filter(d.astype(np.float32), labels)
    rgb_centers = np.clip(inv_map_drgb_np(centers_d.astype(np.float32), intensity_factor), 0, 1)
    return Cluster(anchors=anchors, links=links, rgb_centers=rgb_centers,
                   intensity_factor=intensity_factor)


class ClusterManager:
    """One ``Cluster`` per semantic class (a single one with
    ``no_semantic_tree``)."""

    def __init__(self, class_num: int = 0, clusters: Optional[List] = None):
        self.class_num = class_num
        self.clusters: List[Optional[Cluster]] = clusters if clusters is not None else []

    def update_centers(self, labels: np.ndarray, pixels: np.ndarray, quantile: float = 0.3,
                       n_samples: int = 5000, band_factor: float = 0.5):
        """Rebuild every class's clusters from rendered albedo samples."""
        pixels = np.asarray(pixels).reshape(-1, 3)
        labels = np.asarray(labels).reshape(-1)
        self.clusters = []
        if self.class_num == 1:
            self.clusters.append(build_cluster(pixels, quantile, n_samples, band_factor))
            return
        for i in range(self.class_num):
            class_pixels = pixels[labels == i]
            if len(class_pixels) == 0:
                self.clusters.append(None)
                continue
            self.clusters.append(build_cluster(class_pixels, quantile, n_samples, band_factor))

    def to_table(self, anchors_per_class: int = 2048, device="cuda") -> ClusterTable:
        """The palette as a padded table on ``device`` (default ``"cuda"``,
        which raises without a GPU)."""
        per_class = [None if c is None else (c.anchors, c.links, c.rgb_centers)
                     for c in self.clusters]
        f = next((c.intensity_factor for c in self.clusters if c is not None), 0.5)
        return table_from_numpy(per_class, anchors_per_class, f, device=device)

    def save(self, manager_dir: str):
        os.makedirs(manager_dir, exist_ok=True)
        cluster_dirs = []
        for i, c in enumerate(self.clusters):
            if c is None:
                cluster_dirs.append(None)
            else:
                d = os.path.join(manager_dir, f"c{i}")
                c.save(d)
                cluster_dirs.append(d)
        with open(os.path.join(manager_dir, "clusters.json"), "w") as f:
            json.dump({"class_num": self.class_num, "cluster_dirs": cluster_dirs}, f)

    @classmethod
    def load(cls, manager_dir: str) -> "ClusterManager":
        with open(os.path.join(manager_dir, "clusters.json")) as f:
            data = json.load(f)
        mgr = cls(class_num=data["class_num"])
        for i, d in enumerate(data["cluster_dirs"]):
            mgr.clusters.append(None if d is None
                                else Cluster.load(os.path.join(manager_dir, f"c{i}")))
        return mgr
