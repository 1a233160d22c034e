"""ScanNet scene dataset (the SSR pipeline's ScanNet loader).

The port's numpy copy of ``intrinsicnerf_tpu/data/scannet.py``: frames
under ``renders/{color,depth,pose}``; the 968x1296 colour and the labels
padded by 2 rows at the top and bottom to 972 (4:3), the depth (uint16
mm) not padded before its resize; labels from
``<scene>_2d-label-filt/label-filt`` (raw ids clipped to the largest id
of ``scannetv2-labels.combined.tsv``) mapped to NYU40 or NYU13; the
per-scene intrinsics from ``<scene>.txt``; frames with a non-finite pose
skipped; every ``sample_step``-th frame trains and the frames offset by
``sample_step // 2`` test (the last one dropped when it runs past the
end).  Images are read and resized with OpenCV, as the JAX package
reads them.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# ScanNet id -> NYU13 mapping path: tsv column 4 is nyu40; nyu40->nyu13
# reduction table (the standard Eigen13 grouping SSR uses).
NYU40_TO_NYU13 = np.array(
    [0, 12, 5, 6, 1, 4, 9, 10, 12, 13, 6, 8, 6, 13, 10, 6, 13, 6, 7, 7, 5, 7,
     3, 2, 6, 11, 7, 7, 7, 7, 7, 7, 6, 7, 7, 7, 7, 7, 7, 6, 7],
    dtype=np.int64,
)


def load_scannet_nyu40_mapping(scene_dir: str) -> Dict[int, int]:
    mapping = {}
    with open(os.path.join(scene_dir, "scannetv2-labels.combined.tsv")) as f:
        for i, line in enumerate(csv.reader(f, delimiter="\t")):
            if i == 0:
                continue
            mapping[int(line[0])] = int(line[4])
    return mapping


def load_scannet_nyu13_mapping(scene_dir: str) -> Dict[int, int]:
    return {
        k: int(NYU40_TO_NYU13[v]) if v < len(NYU40_TO_NYU13) else 0
        for k, v in load_scannet_nyu40_mapping(scene_dir).items()
    }


@dataclass
class ScanNetDataset:
    train_samples: Dict[str, np.ndarray]
    test_samples: Dict[str, np.ndarray]
    train_ids: List[int]
    test_ids: List[int]
    intrinsics: np.ndarray  # [3,3]
    semantic_classes: np.ndarray
    num_semantic_class: int
    mask_ids: np.ndarray
    train_num: int = field(init=False)
    test_num: int = field(init=False)

    def __post_init__(self):
        self.train_num = len(self.train_ids)
        self.test_num = len(self.test_ids)


def load_scannet(
    scene_dir: str,
    scene_name: str,
    mode: str = "nyu40",
    img_h: Optional[int] = None,
    img_w: Optional[int] = None,
    sample_step: int = 5,
) -> ScanNetDataset:
    import cv2

    label_dir = os.path.join(scene_dir, f"{scene_name}_2d-label-filt", "label-filt")
    if mode == "nyu40":
        label_map = load_scannet_nyu40_mapping(scene_dir)
    elif mode == "nyu13":
        label_map = load_scannet_nyu13_mapping(scene_dir)
    else:
        raise ValueError(f"unknown label mode {mode}")

    with open(os.path.join(scene_dir, f"{scene_name}.txt")) as f:
        info = dict(line.rstrip().split(" = ") for line in f)
    intrinsics = np.array(
        [
            [float(info["fx_color"]), 0, float(info["mx_color"])],
            [0, float(info["fy_color"]), float(info["my_color"])],
            [0, 0, 1],
        ]
    )

    frame_ids = sorted(
        int(os.path.splitext(p)[0])
        for p in os.listdir(os.path.join(scene_dir, "renders", "color"))
    )
    frames = []
    for fid in frame_ids:
        pose = np.loadtxt(os.path.join(scene_dir, "renders", "pose", f"{fid}.txt"))
        if not np.all(np.isfinite(pose)):
            continue
        frames.append(
            {
                "image": os.path.join(scene_dir, "renders", "color", f"{fid}.jpg"),
                "depth": os.path.join(scene_dir, "renders", "depth", f"{fid}.png"),
                "label": os.path.join(label_dir, f"{fid}.png"),
                "pose": pose,
            }
        )

    n = len(frames)
    train_ids = list(range(0, n, sample_step))
    test_ids = [x + sample_step // 2 for x in train_ids]
    if test_ids and test_ids[-1] > n - 1:
        test_ids.pop(-1)

    # vectorized raw->nyu remap table
    max_raw = max(label_map) if label_map else 0
    raw2nyu = np.zeros(max_raw + 1, np.int64)
    for k, v in label_map.items():
        raw2nyu[k] = v

    def load_frame(frame):
        image = cv2.imread(frame["image"])[:, :, ::-1]
        image = cv2.copyMakeBorder(
            image, 2, 2, 0, 0, cv2.BORDER_CONSTANT, value=[0, 0, 0]
        )
        image = image / 255.0
        depth = cv2.imread(frame["depth"], cv2.IMREAD_UNCHANGED) / 1000.0
        sem_raw = cv2.imread(frame["label"], cv2.IMREAD_UNCHANGED)
        sem_raw = cv2.copyMakeBorder(sem_raw, 2, 2, 0, 0, cv2.BORDER_CONSTANT, value=0)
        sem = raw2nyu[np.clip(sem_raw, 0, max_raw)]
        if img_h is not None and (img_h != image.shape[0] or img_w != image.shape[1]):
            image = cv2.resize(image, (img_w, img_h), interpolation=cv2.INTER_LINEAR)
            sem = cv2.resize(
                sem.astype(np.int32), (img_w, img_h), interpolation=cv2.INTER_NEAREST
            ).astype(np.int64)
        if img_h is not None and (
            img_h != depth.shape[0] or img_w != depth.shape[1]
        ):
            depth = cv2.resize(depth, (img_w, img_h), interpolation=cv2.INTER_LINEAR)
        return image, depth, sem, frame["pose"]

    def collect(ids):
        out = {"image": [], "depth": [], "semantic": [], "T_wc": []}
        for i in ids:
            img, dep, sem, t = load_frame(frames[i])
            out["image"].append(img)
            out["depth"].append(dep)
            out["semantic"].append(sem)
            out["T_wc"].append(t)
        return {
            k: np.asarray(v, np.float32 if k != "semantic" else np.int64)
            for k, v in out.items()
        }

    train = collect(train_ids)
    test = collect(test_ids)
    classes = np.unique(
        np.concatenate([np.unique(train["semantic"]), np.unique(test["semantic"])])
    )
    remap = np.zeros(int(classes.max()) + 1, np.int64)
    remap[classes] = np.arange(len(classes))
    train["semantic_remap"] = remap[train["semantic"]]
    train["semantic_remap_clean"] = train["semantic_remap"].copy()
    test["semantic_remap"] = remap[test["semantic"]]

    return ScanNetDataset(
        train_samples=train,
        test_samples=test,
        train_ids=train_ids,
        test_ids=test_ids,
        intrinsics=intrinsics,
        semantic_classes=classes,
        num_semantic_class=len(classes),
        mask_ids=np.ones(len(train_ids), np.int64),
    )
