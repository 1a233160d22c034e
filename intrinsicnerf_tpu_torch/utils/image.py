"""Image utilities for writing rendered views (numpy; copied from
``intrinsicnerf_tpu/utils/image.py`` so the port keeps the original file
naming and colours), and PNG reading and writing through OpenCV in RGB
order, as ``imageio`` reads and writes them for the JAX package."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def _bitget(byteval, idx):
    return (byteval & (1 << idx)) != 0


def label_colormap(n: int = 256) -> np.ndarray:
    """PASCAL-VOC-style label colormap ``[n, 3] uint8``."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= _bitget(c, 0) << (7 - j)
            g |= _bitget(c, 1) << (7 - j)
            b |= _bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def depth2rgb(
    depth: np.ndarray,
    min_value: Optional[float] = None,
    max_value: Optional[float] = None,
) -> np.ndarray:
    """Normalize a depth map and colorize with a jet-style colormap
    (uint8 HxWx3)."""
    depth = np.asarray(depth, np.float32)
    lo = float(np.nanmin(depth)) if min_value is None else min_value
    hi = float(np.nanmax(depth)) if max_value is None else max_value
    t = np.clip((depth - lo) / max(hi - lo, 1e-10), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return to8b(np.stack([r, g, b], axis=-1))


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write an ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` uint8 / uint16
    array as an image (RGB or RGBA order), as ``imageio.v2.imwrite`` does."""
    import cv2

    arr = np.asarray(arr)
    if arr.ndim == 3:
        arr = np.ascontiguousarray(_swap_rb(arr))  # OpenCV writes BGR(A)
    if not cv2.imwrite(path, arr):
        raise OSError(f"could not write {path}")


def imread(path: str) -> np.ndarray:
    """Read an image as written (RGB or RGBA order, uint8 or uint16
    unchanged)."""
    import cv2

    arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise OSError(f"could not read {path}")
    return _swap_rb(arr).copy() if arr.ndim == 3 else arr


def _swap_rb(arr: np.ndarray) -> np.ndarray:
    """BGR(A) <-> RGB(A): the colour channels reversed, alpha kept last."""
    return np.concatenate([arr[..., 2::-1], arr[..., 3:]], axis=-1)


def plot_semantic_legend(
    label_ids: Sequence[int],
    label_names: Sequence[str],
    colormap: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    filename: str = "semantic_class_Legend",
) -> np.ndarray:
    """A colour/name legend strip of the semantic classes present (names
    drawn with matplotlib where it is installed, else a colour bar)."""
    label_ids = np.unique(np.asarray(label_ids))
    if colormap is None:
        colormap = label_colormap(int(label_ids.max()) + 1)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(3, 0.3 * len(label_ids) + 0.5))
        for i, lid in enumerate(label_ids):
            color = np.asarray(colormap[lid], np.float32)
            if color.max() > 1:
                color = color / 255.0
            ax.barh(i, 1, color=color)
            name = label_names[lid] if lid < len(label_names) else str(lid)
            ax.text(0.5, i, name, va="center", ha="center", fontsize=7)
        ax.set_axis_off()
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
    except ImportError:
        img = np.stack([colormap[lid] for lid in label_ids])[:, None, :]
        img = np.repeat(np.repeat(img, 20, axis=0), 100, axis=1).astype(np.uint8)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        imwrite(os.path.join(save_path, f"{filename}.png"), img)
    return img
