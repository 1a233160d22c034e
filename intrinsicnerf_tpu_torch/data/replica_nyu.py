"""Replica with CNN-predicted NYU labels (the label-propagation experiments).

The port's numpy copy of ``intrinsicnerf_tpu/data/replica_nyu.py``: the
Replica layout (``rgb/``, ``depth/``, ``traj_w_c.txt``) with the labels
trained on from ``CNN_semantic_class_nyu13`` / ``CNN_semantic_class_nyu34``
and the ground-truth labels (``semantic_class_nyu13_remap`` /
``semantic_class_nyu40_remap_nyu34``) kept in ``semantic_remap_clean`` for
evaluation, in both splits; ``gt_nyu13`` trains on the ground truth.
The class count is the largest label of either kind plus one.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_DIRS = {
    "nyu13": ("CNN_semantic_class_nyu13", "semantic_class_nyu13_remap"),
    "nyu34": ("CNN_semantic_class_nyu34", "semantic_class_nyu40_remap_nyu34"),
    "gt_nyu13": ("semantic_class_nyu13_remap", "semantic_class_nyu13_remap"),
}


def _num_key(path: str) -> int:
    return int(os.path.basename(path).rsplit("_", 1)[-1][:-4])


@dataclass
class ReplicaNYUDataset:
    train_samples: Dict[str, np.ndarray]
    test_samples: Dict[str, np.ndarray]
    train_ids: List[int]
    test_ids: List[int]
    nyu_mode: str
    num_semantic_class: int
    mask_ids: np.ndarray
    train_num: int = field(init=False)
    test_num: int = field(init=False)

    def __post_init__(self):
        self.train_num = len(self.train_ids)
        self.test_num = len(self.test_ids)


def load_replica_nyu_cnn(
    data_dir: str,
    train_ids: List[int],
    test_ids: List[int],
    nyu_mode: str = "nyu13",
    img_h: Optional[int] = None,
    img_w: Optional[int] = None,
) -> ReplicaNYUDataset:
    import cv2

    if nyu_mode not in _DIRS:
        raise ValueError(f"nyu_mode must be one of {list(_DIRS)}")
    cnn_dir, gt_dir = _DIRS[nyu_mode]

    traj = np.loadtxt(os.path.join(data_dir, "traj_w_c.txt"), delimiter=" ").reshape(
        -1, 4, 4
    )
    rgb_list = sorted(glob.glob(os.path.join(data_dir, "rgb", "rgb*.png")), key=_num_key)
    depth_list = sorted(
        glob.glob(os.path.join(data_dir, "depth", "depth*.png")), key=_num_key
    )
    cnn_list = sorted(
        glob.glob(os.path.join(data_dir, cnn_dir, "semantic_class_*.png")),
        key=_num_key,
    )
    gt_list = sorted(
        glob.glob(os.path.join(data_dir, gt_dir, "semantic_class_*.png")),
        key=_num_key,
    )

    def load_frame(idx):
        image = cv2.imread(rgb_list[idx])[:, :, ::-1] / 255.0
        depth = cv2.imread(depth_list[idx], cv2.IMREAD_UNCHANGED) / 1000.0
        cnn_sem = cv2.imread(cnn_list[idx], cv2.IMREAD_UNCHANGED)
        gt_sem = cv2.imread(gt_list[idx], cv2.IMREAD_UNCHANGED)
        if img_h is not None and (img_h != image.shape[0] or img_w != image.shape[1]):
            image = cv2.resize(image, (img_w, img_h), interpolation=cv2.INTER_LINEAR)
            depth = cv2.resize(depth, (img_w, img_h), interpolation=cv2.INTER_LINEAR)
            cnn_sem = cv2.resize(
                cnn_sem, (img_w, img_h), interpolation=cv2.INTER_NEAREST
            )
            gt_sem = cv2.resize(
                gt_sem, (img_w, img_h), interpolation=cv2.INTER_NEAREST
            )
        return image, depth, cnn_sem, gt_sem, traj[idx]

    def collect(ids):
        out = {"image": [], "depth": [], "cnn_semantic": [], "gt_semantic": [], "T_wc": []}
        for idx in ids:
            img, dep, cnn, gt, t = load_frame(idx)
            out["image"].append(img)
            out["depth"].append(dep)
            out["cnn_semantic"].append(cnn)
            out["gt_semantic"].append(gt)
            out["T_wc"].append(t)
        arrs = {}
        for k, v in out.items():
            dtype = np.int64 if "semantic" in k else np.float32
            arrs[k] = np.asarray(v, dtype)
        # train against CNN labels; eval against GT
        arrs["semantic_remap"] = arrs["cnn_semantic"]
        arrs["semantic_remap_clean"] = arrs["gt_semantic"]
        return arrs

    train = collect(train_ids)
    test = collect(test_ids)
    num_class = int(
        max(
            train["cnn_semantic"].max(), train["gt_semantic"].max(),
            test["cnn_semantic"].max(), test["gt_semantic"].max(),
        )
        + 1
    )
    return ReplicaNYUDataset(
        train_samples=train,
        test_samples=test,
        train_ids=list(train_ids),
        test_ids=list(test_ids),
        nyu_mode=nyu_mode,
        num_semantic_class=num_class,
        mask_ids=np.ones(len(train_ids), np.int64),
    )
