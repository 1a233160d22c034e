"""Dataset -> device bundle for the scene and the object pipelines.

Port of ``intrinsicnerf_tpu/train/prepare.py`` (``replica_intrinsics``,
``prepare_replica_bundle``, ``prepare_scannet_bundle``,
``apply_ndc_to_rays``, ``prepare_blender_bundle``).

- Replica, and Replica-NYU with the NYU-13/34 palettes and names: its
  90-degree pinhole camera with ``cx = (W-1)/2``; the per-image training
  ray and GT pools uploaded once; the scaled train-view rays
  (``rays_vis``, kept on the device as JAX keeps them: 720 x 76,800 x 11
  fp32 = 2.4 GB at full Replica) and test-view rays; the scaled GT for
  evaluation (bilinear images and depth, nearest labels shifted so void
  = -1), resized with OpenCV as the JAX package resizes them.
- ScanNet: the scene's own intrinsics rescaled to the config's size, the
  scaled views centred at ``(W_s-0.5)/2`` as the JAX package centres them.
- Objects (Blender, Blender-intrinsic, LLFF, DeepVoxels, LINEMOD): the
  white-background composite, the alpha masks, the pose pools of the
  object sampler (``PosePools``) and the test and render-path rays at
  full resolution.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.config import FrameworkConfig
from intrinsicnerf_tpu_torch.core.rays import camera_ray_dirs, create_rays, ndc_rays
from intrinsicnerf_tpu_torch.data.blender import BlenderData, composite_white_background
from intrinsicnerf_tpu_torch.train.step import DataPools, PosePools
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle
from intrinsicnerf_tpu_torch.utils.image import (
    label_colormap, nyu13_class_names, nyu13_colour_code, nyu34_class_names, nyu34_colour_code)


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
    cmap, names, class_ids = None, getattr(data, "class_names", None), None
    if cfg.experiment.enable_semantic:
        nyu_mode = getattr(data, "nyu_mode", None)
        if nyu_mode in ("nyu13", "nyu34"):  # the NYU palettes and names
            if nyu_mode == "nyu13":
                cmap = (np.asarray(nyu13_colour_code) * 255).astype(np.uint8)
                names = nyu13_class_names
            else:
                cmap, names = nyu34_colour_code, nyu34_class_names
            class_ids = np.arange(len(names))
        else:
            class_ids = getattr(data, "semantic_classes", None)
            classes = class_ids if class_ids is not None else np.arange(num_valid + 1)
            cmap = label_colormap(int(np.max(classes)) + 2)[np.asarray(classes)]

    return SceneBundle(
        pools=pools, rays_vis=rays_vis, rays_test=rays_test, h=h, w=w, h_scaled=hs,
        w_scaled=ws, num_valid_classes=num_valid, test_gt=test_gt, train_gt=train_gt,
        colour_map=cmap, class_names=names,
        semantic_class_ids=np.asarray(class_ids) if class_ids is not None else None,
    )


def prepare_scannet_bundle(cfg: FrameworkConfig, data, device="cuda") -> SceneBundle:
    """``data`` is a loaded ``ScanNetDataset``: its intrinsics rescaled from
    the padded native frame to the config's size, the scaled views'
    centres at ``(ws - 0.5) / 2``, ``(hs - 0.5) / 2``; the samples resized
    in place when the height differs; depth and semantic pools whatever
    ``enable_*`` says; no train-set GT and no colour map.  Tensors go to
    ``device`` (default ``"cuda"``, which raises without a GPU)."""
    dev = resolve_device(device)
    h, w = cfg.experiment.height, cfg.experiment.width
    near, far = cfg.depth_range
    f = cfg.test_viz_factor
    hs, ws = h // f, w // f
    k = data.intrinsics
    native_h, native_w = data.train_samples["image"].shape[1:3]
    sx, sy = w / native_w, h / native_h
    fx, fy, cx, cy = k[0, 0] * sx, k[1, 1] * sy, k[0, 2] * sx, k[1, 2] * sy
    fxs, fys = fx / f, fy / f
    cxs, cys = (ws - 0.5) / 2.0, (hs - 0.5) / 2.0

    train, test = data.train_samples, data.test_samples
    if train["image"].shape[1] != h:
        for s in (train, test):
            s["image"] = _resize_stack(s["image"], h, w)
            s["depth"] = _resize_stack(s["depth"], h, w)
            s["semantic_remap"] = _resize_stack(s["semantic_remap"], h, w,
                                                nearest=True).astype(np.int64)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    conv = cfg.experiment.convention
    n_train = train["image"].shape[0]
    pools = DataPools(
        rays=create_rays(t(train["T_wc"]), h, w, fx, fy, cx, cy, near, far, convention=conv),
        rgb=t(train["image"].reshape(n_train, -1, 3)),
        depth=t(train["depth"].reshape(n_train, -1)),
        semantic=t(train["semantic_remap"].reshape(n_train, -1), torch.int64),
        mask_ids=t(np.asarray(data.mask_ids, np.int64), torch.int64),
    )
    rays_vis = create_rays(t(train["T_wc"]), hs, ws, fxs, fys, cxs, cys, near, far,
                           convention=conv)
    rays_test = create_rays(t(test["T_wc"]), hs, ws, fxs, fys, cxs, cys, near, far,
                            convention=conv)
    test_gt = {
        "image": _resize_stack(test["image"], hs, ws),
        "depth": _resize_stack(test["depth"], hs, ws),
        "semantic": _resize_stack(test["semantic_remap"], hs, ws,
                                  nearest=True).astype(np.int64) - 1,
    }
    return SceneBundle(
        pools=pools, rays_vis=rays_vis, rays_test=rays_test, h=h, w=w, h_scaled=hs,
        w_scaled=ws, num_valid_classes=data.num_semantic_class - 1, test_gt=test_gt,
        colour_map=None)


def apply_ndc_to_rays(rays: torch.Tensor, h: int, w: int, focal: float) -> torch.Tensor:
    """Project a ``[..., 11]`` ray block to NDC (bounds become [0, 1]; the
    view directions keep their world-space values)."""
    o, d = ndc_rays(h, w, focal, 1.0, rays[..., 0:3], rays[..., 3:6])
    nf = torch.tensor([0.0, 1.0], dtype=rays.dtype, device=rays.device)
    return torch.cat([o, d, nf.expand(*rays.shape[:-1], 2), rays[..., 8:11]], dim=-1)


def prepare_blender_bundle(cfg: FrameworkConfig, data: BlenderData, ndc_focal=None,
                           device="cuda") -> Tuple[SceneBundle, PosePools]:
    """The object pipeline's bundle and the ``PosePools`` its pose sampler
    reads: the white-background composite (per config), the alpha masks,
    the camera-frame pixel directions (OpenGL, ``cx = w/2``), the test
    views' rays (which the rebuilds render too) and the render path's.
    ``ndc_focal`` set projects the test and path rays to NDC (LLFF
    forward-facing).  Tensors go to ``device`` (default ``"cuda"``, which
    raises without a GPU)."""
    dev = resolve_device(device)
    near, far = cfg.depth_range
    h, w, focal = data.h, data.w, data.focal
    i_train, _, i_test = data.i_split
    images = (composite_white_background(data.images) if cfg.render.white_bkgd
              else data.images[..., :3])
    masks = data.images[..., 3]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    dirs_cam = camera_ray_dirs(h, w, focal, focal, w * 0.5, h * 0.5, convention="opengl",
                               device=dev).reshape(-1, 3)
    pools = PosePools(dirs_cam=dirs_cam, poses=t(data.poses[i_train]),
                      rgb=t(images[i_train].reshape(len(i_train), -1, 3)),
                      mask=t(masks[i_train].reshape(len(i_train), -1)))
    rays_test = create_rays(t(data.poses[i_test]), h, w, focal, focal, w * 0.5, h * 0.5, near,
                            far, convention="opengl")
    rays_vis = create_rays(t(data.render_poses), h, w, focal, focal, w * 0.5, h * 0.5, near,
                           far, convention="opengl")
    if ndc_focal is not None:
        rays_test = apply_ndc_to_rays(rays_test, h, w, ndc_focal)
        rays_vis = apply_ndc_to_rays(rays_vis, h, w, ndc_focal)
    bundle = SceneBundle(
        pools=pools, rays_vis=rays_vis, rays_test=rays_test, h=h, w=w, h_scaled=h, w_scaled=w,
        num_valid_classes=0,
        # an object rebuilds its clusters from the test views, not the render path
        rays_cluster=rays_test,
        test_gt={"image": np.asarray(images[i_test], np.float32)})
    return bundle, pools
