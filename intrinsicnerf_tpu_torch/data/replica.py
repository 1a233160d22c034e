"""Replica scene dataset (the scene pipeline's loader).

The port's numpy copy of ``intrinsicnerf_tpu/data/replica.py``: per
sequence ``rgb/rgb_*.png``, ``depth/depth_*.png`` (uint16 mm -> metres),
``semantic_class/semantic_class_*.png`` and ``traj_w_c.txt`` (flattened
4x4 world-from-camera poses); the train/test split takes every 5th of
900 frames, offset 0 / 2; labels are remapped to a dense [0, C) range
(void = 0), and ``mask_ids`` marks the training frames that carry a
semantic loss.  Images are read and resized with OpenCV, as the JAX
package reads them.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def default_replica_split(total: int = 900, step: int = 5):
    """train = frames 0,5,...; test = frames 2,7,... (offset 2)."""
    train_ids = list(range(0, total, step))
    test_ids = [x + step // 2 for x in train_ids if x + step // 2 < total]
    return train_ids, test_ids


def _num_key(path: str) -> int:
    return int(os.path.basename(path).rsplit("_", 1)[-1][:-4])


@dataclass
class ReplicaDataset:
    train_samples: Dict[str, np.ndarray]
    test_samples: Dict[str, np.ndarray]
    train_ids: List[int]
    test_ids: List[int]
    semantic_classes: np.ndarray  # original ids present, incl. void 0
    num_semantic_class: int  # len(semantic_classes), incl. void
    mask_ids: np.ndarray  # [train_num] 1 = semantic loss active
    class_names: Optional[List[str]] = None  # ["void", ...] by original id
    train_num: int = field(init=False)
    test_num: int = field(init=False)

    def __post_init__(self):
        self.train_num = len(self.train_ids)
        self.test_num = len(self.test_ids)


def load_replica(
    data_dir: str,
    train_ids: List[int],
    test_ids: List[int],
    img_h: Optional[int] = None,
    img_w: Optional[int] = None,
) -> ReplicaDataset:
    import cv2

    traj = np.loadtxt(os.path.join(data_dir, "traj_w_c.txt"), delimiter=" ").reshape(
        -1, 4, 4
    )
    rgb_list = sorted(glob.glob(os.path.join(data_dir, "rgb", "rgb*.png")), key=_num_key)
    depth_list = sorted(
        glob.glob(os.path.join(data_dir, "depth", "depth*.png")), key=_num_key
    )
    sem_list = sorted(
        glob.glob(os.path.join(data_dir, "semantic_class", "semantic_class_*.png")),
        key=_num_key,
    )
    inst_list = sorted(
        glob.glob(
            os.path.join(data_dir, "semantic_instance", "semantic_instance_*.png")
        ),
        key=_num_key,
    )
    has_instance = len(inst_list) > 0

    def load_frame(idx):
        image = cv2.imread(rgb_list[idx])[:, :, ::-1] / 255.0
        depth = cv2.imread(depth_list[idx], cv2.IMREAD_UNCHANGED) / 1000.0
        semantic = cv2.imread(sem_list[idx], cv2.IMREAD_UNCHANGED)
        instance = (
            cv2.imread(inst_list[idx], cv2.IMREAD_UNCHANGED)
            if has_instance
            else None
        )
        if img_h is not None and (
            img_h != image.shape[0] or img_w != image.shape[1]
        ):
            image = cv2.resize(image, (img_w, img_h), interpolation=cv2.INTER_LINEAR)
            depth = cv2.resize(depth, (img_w, img_h), interpolation=cv2.INTER_LINEAR)
            semantic = cv2.resize(
                semantic, (img_w, img_h), interpolation=cv2.INTER_NEAREST
            )
            if instance is not None:
                instance = cv2.resize(
                    instance, (img_w, img_h), interpolation=cv2.INTER_NEAREST
                )
        return image, depth, semantic, instance, traj[idx]

    def collect(ids):
        out = {"image": [], "depth": [], "semantic": [], "T_wc": []}
        if has_instance:
            out["instance"] = []
        for idx in ids:
            img, dep, sem, inst, t = load_frame(idx)
            out["image"].append(img)
            out["depth"].append(dep)
            out["semantic"].append(sem)
            if has_instance:
                out["instance"].append(inst)
            out["T_wc"].append(t)
        return {
            k: np.asarray(
                v, np.float32 if k not in ("semantic", "instance") else np.int64
            )
            for k, v in out.items()
        }

    train = collect(train_ids)
    test = collect(test_ids)

    semantic_classes = np.unique(
        np.concatenate(
            [np.unique(train["semantic"]), np.unique(test["semantic"])]
        )
    ).astype(np.int64)
    remap = np.zeros(int(semantic_classes.max()) + 1, np.int64)
    remap[semantic_classes] = np.arange(len(semantic_classes))

    train["semantic_clean"] = train["semantic"].copy()
    train["semantic_remap"] = remap[train["semantic"]]
    train["semantic_remap_clean"] = train["semantic_remap"].copy()
    test["semantic_remap"] = remap[test["semantic"]]

    return ReplicaDataset(
        train_samples=train,
        test_samples=test,
        train_ids=list(train_ids),
        test_ids=list(test_ids),
        semantic_classes=semantic_classes,
        num_semantic_class=len(semantic_classes),
        mask_ids=np.ones(len(train_ids), np.int64),
        class_names=_load_class_names(data_dir),
    )


def rebuild_semantic_remap(
    data: ReplicaDataset, semantic_classes: np.ndarray
) -> ReplicaDataset:
    """Recompute the dense [0, C) label remap against an externally agreed
    class set (a process that loads only a shard of the images sees fewer
    classes; the remap, and with it the semantic head's width, must come
    from the union over all of them).  Mutates and returns ``data``."""
    semantic_classes = np.unique(np.asarray(semantic_classes, np.int64))
    remap = np.zeros(int(semantic_classes.max()) + 1, np.int64)
    remap[semantic_classes] = np.arange(len(semantic_classes))

    for samples in (data.train_samples, data.test_samples):
        if "semantic" in samples and samples["semantic"].size:
            observed = np.unique(samples["semantic"])
            if not np.isin(observed, semantic_classes).all():
                raise ValueError("labels outside the agreed class set: "
                                 f"{np.setdiff1d(observed, semantic_classes)}")
            samples["semantic_remap"] = remap[samples["semantic"]]
    if data.train_samples.get("semantic") is not None:
        data.train_samples["semantic_remap_clean"] = data.train_samples[
            "semantic_remap"
        ].copy()
    data.semantic_classes = semantic_classes
    data.num_semantic_class = len(semantic_classes)
    return data


def _load_class_names(data_dir: str) -> Optional[List[str]]:
    """Replica class-name table from ``info_semantic.json`` (searched in
    the sequence dir and its parents, where the official release puts
    it); names are indexed by original class id with void prepended
    (reference ``trainer.py:170-183``)."""
    import json

    for cand_dir in (data_dir, os.path.dirname(data_dir),
                     os.path.dirname(os.path.dirname(data_dir))):
        path = os.path.join(cand_dir, "info_semantic.json")
        if os.path.isfile(path):
            try:
                with open(path) as f:
                    info = json.load(f)
                return ["void"] + [c["name"] for c in info["classes"]]
            except (KeyError, TypeError, ValueError) as e:
                print(f"[replica] unreadable {path}: {e}")
                return None
    return None
