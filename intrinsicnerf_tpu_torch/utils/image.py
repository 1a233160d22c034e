"""Image utilities for writing rendered views (numpy; copied from
``intrinsicnerf_tpu/utils/image.py`` so the port keeps the original file
naming and colours)."""

from __future__ import annotations

from typing import Optional

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
