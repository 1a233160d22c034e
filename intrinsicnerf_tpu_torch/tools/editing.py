"""Headless scene editing: recolouring and relighting from rendered
intrinsic decompositions and a saved cluster palette.

Port of ``intrinsicnerf_tpu/tools/editing.py``: load the rendered
``albedo_*/shading_*/residual_*/label_*`` PNGs of a frame, find each
pixel's albedo cluster with ``cluster/assign.py:dest_class`` (on
``device``, default ``"cuda"``), then recompose ``edit = cluster_albedo *
t(shading) * s + t(residual) * r``, where a cluster's colour is editable
and ``s``/``r`` are global scales with optional nonlinear transfers.
Frames, palettes and saved files keep the reference names and JSON
format, so the JAX tools and this one read each other's output.  The Tk
view over this class is ``intrinsicnerf_tpu_torch/gui.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.cluster.assign import ClusterTable, dest_class
from intrinsicnerf_tpu_torch.cluster.manager import ClusterManager
from intrinsicnerf_tpu_torch.utils.image import imread, imwrite


def _imread(path):
    return np.asarray(imread(path), np.float32) / 255.0


class EditSession:
    """One editable frame set (all frames of a render directory); the
    cluster table and the per-pixel cluster search live on ``device``."""

    def __init__(self, img_dir: str, cluster_dir: str, device="cuda"):
        self.img_dir = img_dir
        self.device = resolve_device(device)
        self.manager = ClusterManager.load(cluster_dir)
        self.table: ClusterTable = self.manager.to_table(device=self.device)
        # palette working copy: per (class, cluster) -> rgb
        self.palette = [
            None if c is None else np.asarray(c.rgb_centers, np.float32).copy()
            for c in self.manager.clusters
        ]
        self.shading_scale = 1.0
        self.residual_scale = 1.0
        self.shading_gamma = 1.0  # power transfer (1 = linear)
        # reference nonlinear transfer toggles:
        # t_shading(s) = s^2; t_residual(r) = (sin(r*pi - pi/2) + 1) / 2
        self.shading_transfer = False
        self.residual_transfer = False
        self.frames: Dict[int, dict] = {}

    # ----------------------------------------------------------- frames

    def frame_ids(self):
        out = []
        for name in sorted(os.listdir(self.img_dir)):
            if name.startswith("albedo_") and name.endswith(".png"):
                out.append(int(name[len("albedo_"):-4]))
        return out

    def load_frame(self, idx: int) -> dict:
        if idx in self.frames:
            return self.frames[idx]
        d = self.img_dir
        albedo = _imread(os.path.join(d, f"albedo_{idx:03d}.png"))[..., :3]
        shading = _imread(os.path.join(d, f"shading_{idx:03d}.png"))
        if shading.ndim == 3:
            shading = shading[..., 0]
        residual = _imread(os.path.join(d, f"residual_{idx:03d}.png"))[..., :3]
        label_path = os.path.join(d, f"label_{idx:03d}.png")
        if os.path.exists(label_path):
            label = np.asarray(imread(label_path), np.int64)
        else:
            label = np.zeros(albedo.shape[:2], np.int64)

        h, w = albedo.shape[:2]
        cls = dest_class(
            self.table,
            torch.from_numpy(albedo.reshape(-1, 3)).to(self.device),
            torch.from_numpy(label.reshape(-1)).to(self.device),
        )
        frame = {
            "albedo": albedo,
            "shading": shading,
            "residual": residual,
            "label": label,
            "cluster": cls.cpu().numpy().reshape(h, w),
        }
        self.frames[idx] = frame
        return frame

    # ---------------------------------------------------------- editing

    def pick(self, idx: int, row: int, col: int) -> Tuple[int, int]:
        """(semantic class, cluster id) at a clicked pixel."""
        frame = self.load_frame(idx)
        return int(frame["label"][row, col]), int(frame["cluster"][row, col])

    def get_cluster_color(self, sem_class: int, cluster_id: int):
        pal = self.palette[sem_class]
        if pal is None or cluster_id < 0 or cluster_id >= len(pal):
            return None
        return pal[cluster_id].copy()

    def set_cluster_color(self, sem_class: int, cluster_id: int, rgb):
        pal = self.palette[sem_class]
        if pal is None:
            raise ValueError(f"class {sem_class} has no clusters")
        pal[cluster_id] = np.asarray(rgb, np.float32)

    def reset_palette(self):
        self.palette = [
            None if c is None else np.asarray(c.rgb_centers, np.float32).copy()
            for c in self.manager.clusters
        ]

    # --------------------------------------------------------- compose

    def cluster_albedo(self, idx: int) -> np.ndarray:
        """Albedo quantized to the *edited* palette."""
        frame = self.load_frame(idx)
        out = frame["albedo"].copy()
        label, cluster = frame["label"], frame["cluster"]
        for sem_class, pal in enumerate(self.palette):
            if pal is None:
                continue
            sel = (label == sem_class) & (cluster >= 0)
            if not sel.any():
                continue
            out[sel] = pal[np.clip(cluster[sel], 0, len(pal) - 1)]
        return out

    def t_shading(self, s: np.ndarray) -> np.ndarray:
        """Reference ``t_shading``: squared transfer when toggled, composed
        with the power-gamma control."""
        if self.shading_transfer:
            s = s**2
        if self.shading_gamma != 1.0:
            s = s**self.shading_gamma
        return s

    def t_residual(self, r: np.ndarray) -> np.ndarray:
        """Reference ``t_residual``: the sine S-curve when toggled."""
        if self.residual_transfer:
            r = (np.sin(r * np.pi - np.pi / 2.0) + 1.0) / 2.0
        return r

    def compose(self, idx: int, use_clusters: bool = True) -> np.ndarray:
        """``edit = albedo' * t(shading)*s + t(residual)*r`` in [0,1]
        (the reference ``update_img``)."""
        frame = self.load_frame(idx)
        albedo = self.cluster_albedo(idx) if use_clusters else frame["albedo"]
        shading = self.t_shading(frame["shading"]) * self.shading_scale
        residual = self.t_residual(frame["residual"]) * self.residual_scale
        return np.clip(albedo * shading[..., None] + residual, 0.0, 1.0)

    def save_edit(self, idx: int, path: str):
        imwrite(path, (self.compose(idx) * 255).astype(np.uint8))

    def save_palette(self, out_dir: str):
        """Write the edited palette back in the reference JSON format."""
        for sem_class, pal in enumerate(self.palette):
            if pal is not None:
                self.manager.clusters[sem_class].rgb_centers = pal.copy()
        self.manager.save(out_dir)
