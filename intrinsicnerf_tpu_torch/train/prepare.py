"""Dataset -> device bundle for the Replica scene pipeline.

Port of ``intrinsicnerf_tpu/train/prepare.py`` (``replica_intrinsics``,
``prepare_replica_bundle``): Replica's 90-degree pinhole camera with
``cx = (W-1)/2``; the per-image training ray and GT pools uploaded once;
the scaled train-view rays (``rays_vis``, kept on the device as JAX keeps
them: 720 x 76,800 x 11 fp32 = 2.4 GB at full Replica) and test-view
rays; and the scaled GT for evaluation (bilinear images and depth,
nearest labels shifted so void = -1), resized with OpenCV as the JAX
package resizes them.  The ScanNet and Blender preparers come with their
datasets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.config import FrameworkConfig
from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.train.step import DataPools
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle
from intrinsicnerf_tpu_torch.utils.image import label_colormap


def _resize_stack(imgs: np.ndarray, h: int, w: int, nearest=False) -> np.ndarray:
    import cv2

    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return np.stack([
        cv2.resize(np.asarray(img, np.float32 if not nearest else img.dtype), (w, h),
                   interpolation=interp)
        for img in imgs])


def replica_intrinsics(w: int, h: int, hfov_deg: float = 90.0):
    fx = w / 2.0 / math.tan(math.radians(hfov_deg / 2.0))
    return fx, fx, (w - 1.0) / 2.0, (h - 1.0) / 2.0


def prepare_replica_bundle(cfg: FrameworkConfig, data, device="cuda") -> SceneBundle:
    """``data`` is a loaded ``ReplicaDataset``; the bundle's tensors go to
    ``device`` (default ``"cuda"``, which raises without a GPU)."""
    dev = resolve_device(device)
    h, w = cfg.experiment.height, cfg.experiment.width
    near, far = cfg.depth_range
    f = cfg.test_viz_factor
    hs, ws = h // f, w // f
    fx, fy, cx, cy = replica_intrinsics(w, h)
    fxs, fys, cxs, cys = replica_intrinsics(ws, hs)
    train, test = data.train_samples, data.test_samples
    conv = cfg.experiment.convention

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    poses = t(train["T_wc"])
    rays = create_rays(poses, h, w, fx, fy, cx, cy, near, far, convention=conv)
    rays_vis = create_rays(poses, hs, ws, fxs, fys, cxs, cys, near, far, convention=conv)
    n_test = len(test["image"])
    if n_test:
        rays_test = create_rays(t(test["T_wc"]), hs, ws, fxs, fys, cxs, cys, near, far,
                                convention=conv)
    else:
        rays_test = torch.zeros((0, hs * ws, 11), dtype=torch.float32, device=dev)

    n_train = train["image"].shape[0]
    pools = DataPools(
        rays=rays,
        rgb=t(train["image"].reshape(n_train, -1, 3)),
        depth=t(train["depth"].reshape(n_train, -1)) if cfg.experiment.enable_depth else None,
        semantic=(t(train["semantic_remap"].reshape(n_train, -1), torch.int64)
                  if cfg.experiment.enable_semantic else None),
        mask_ids=t(np.asarray(data.mask_ids, np.int64), torch.int64),
    )

    # scaled GT for eval; labels shifted so void -> -1
    test_gt = {}
    if n_test:
        test_gt = {"image": _resize_stack(test["image"], hs, ws),
                   "depth": _resize_stack(test["depth"], hs, ws)}
        if cfg.experiment.enable_semantic:
            eval_sem = test.get("semantic_remap_clean", test["semantic_remap"])
            test_gt["semantic"] = _resize_stack(eval_sem, hs, ws, nearest=True).astype(np.int64) - 1
    # train-set GT at the viz scale, for the rebuild render's metrics
    train_gt = {"image": _resize_stack(train["image"], hs, ws)}
    if cfg.experiment.enable_depth:
        train_gt["depth"] = _resize_stack(train["depth"], hs, ws)
    if cfg.experiment.enable_semantic:
        train_sem = train.get("semantic_remap_clean", train["semantic_remap"])
        train_gt["semantic"] = _resize_stack(train_sem, hs, ws, nearest=True).astype(np.int64) - 1

    num_valid = data.num_semantic_class - 1 if cfg.experiment.enable_semantic else 0
    cmap, class_ids = None, None
    if cfg.experiment.enable_semantic:
        class_ids = getattr(data, "semantic_classes", None)
        classes = class_ids if class_ids is not None else np.arange(num_valid + 1)
        cmap = label_colormap(int(np.max(classes)) + 2)[np.asarray(classes)]

    return SceneBundle(
        pools=pools, rays_vis=rays_vis, rays_test=rays_test, h=h, w=w, h_scaled=hs,
        w_scaled=ws, num_valid_classes=num_valid, test_gt=test_gt, train_gt=train_gt,
        colour_map=cmap, class_names=getattr(data, "class_names", None),
        semantic_class_ids=np.asarray(class_ids) if class_ids is not None else None,
    )
