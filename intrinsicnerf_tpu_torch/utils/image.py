"""Image utilities for writing rendered views (numpy; copied from
``intrinsicnerf_tpu/utils/image.py`` so the port keeps the original file
naming and colours, the NYU-13/34/40 palettes and class names included),
and PNG reading and writing through OpenCV in RGB
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


# NYUv2 13-class color code (reference image_utils.py:158-175)
nyu13_colour_code = np.array(
    [
        (0, 0, 0),
        (0, 0, 1),
        (0.9137, 0.3490, 0.1882),
        (0, 0.8549, 0),
        (0.5843, 0, 0.9412),
        (0.8706, 0.9451, 0.0941),
        (1.0000, 0.8078, 0.8078),
        (0, 0.8784, 0.8980),
        (0.4157, 0.5333, 0.8000),
        (0.4588, 0.1137, 0.1608),
        (0.9412, 0.1373, 0.9216),
        (0, 0.6549, 0.6118),
        (0.9765, 0.5451, 0),
        (0.8824, 0.8980, 0.7608),
    ]
)

nyu13_class_names = [
    "void",
    "bed", "books", "ceiling", "chair", "floor",
    "furniture", "objects", "painting/picture", "sofa", "table",
    "TV", "wall", "window",
]

# NYUv2 40-class palette (standard ScanNet/NYU colors; reference
# image_utils.py:229-277); index 0 = void
nyu40_colour_code = np.array(
    [
        (0, 0, 0),
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (178, 76, 76), (247, 182, 210), (66, 188, 102), (219, 219, 141),
        (140, 57, 197), (202, 185, 52), (51, 176, 203), (200, 54, 131),
        (92, 193, 61), (78, 71, 183), (172, 114, 82), (255, 127, 14),
        (91, 163, 138), (153, 98, 156), (140, 153, 101), (158, 218, 229),
        (100, 125, 154), (178, 127, 135), (120, 185, 128), (146, 111, 194),
        (44, 160, 44), (112, 128, 144), (96, 207, 209), (227, 119, 194),
        (213, 92, 176), (94, 106, 211), (82, 84, 163), (100, 85, 144),
    ],
    dtype=np.uint8,
)

# NYUv2 34-class palette: the 40-class palette minus the six classes the
# CNN-label experiments drop (bookshelf, dresser, mirror, shower curtain,
# white board, person — reference image_utils.py:175-221)
_NYU34_DROPPED_NYU40_IDS = (10, 17, 19, 28, 30, 31)
nyu34_colour_code = np.asarray(
    [nyu40_colour_code[i] for i in range(41) if i not in _NYU34_DROPPED_NYU40_IDS],
    dtype=np.uint8,
)

nyu34_class_names = [
    "void",
    "wall", "floor", "cabinet", "bed", "chair",
    "sofa", "table", "door", "window",
    "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "pillow", "floor",
    "clothes", "ceiling", "books", "fridge", "tv",
    "paper", "towel", "box",
    "night stand", "toilet", "sink", "lamp",
    "bath tub", "bag", "other struct", "other furntr", "other prop",
]


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
