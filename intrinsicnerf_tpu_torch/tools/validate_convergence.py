"""Convergence check of the object pipeline on a ray-traced cube.

The port's twin of ``tools_validate_convergence.py``: the same cube views
(60 around the cube at 64 x 64, the last two held out), the same
configuration (8x256 with view directions, bf16, 64 + 64 samples, 512
pairs a step, precrop for 300 steps, white background), ``Trainer`` with
the object pose sampler, then the held-out PSNR, which must exceed 20.
On the card the MLP runs through the fused kernels (kernel 1 forward,
kernel 2 backward); ``--device cpu`` runs their plain versions.

    python -m intrinsicnerf_tpu_torch.tools.validate_convergence [--steps 3000] [--res 64]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from intrinsicnerf_tpu_torch.core.rays import camera_ray_dirs, rays_to_world
from intrinsicnerf_tpu_torch.data.blender import BlenderData, pose_spherical, spherical_render_poses

PSNR_FLOOR = 20.0
FACE_ALBEDO = {0: (0.85, 0.25, 0.2), 1: (0.2, 0.7, 0.3), 2: (0.25, 0.35, 0.85)}


def raytrace_cube_views(n_views: int, res: int, radius: float = 4.0, half: float = 0.8):
    """An axis-aligned cube: face colour by normal, shaded by how head-on
    the ray meets the face; white background.  Returns images [N,H,W,4]
    RGBA and OpenGL c2w poses [N,4,4]."""
    h = w = res
    focal = res * 1.2
    dirs_cam = camera_ray_dirs(h, w, focal, focal, w / 2, h / 2, convention="opengl").reshape(-1, 3)
    images, poses = [], []
    for i in range(n_views):
        theta = 360.0 * i / n_views
        c2w = np.asarray(pose_spherical(theta, -25.0, radius), np.float32)
        o, d = rays_to_world(torch.from_numpy(c2w), dirs_cam[None])
        o, d = o[0].numpy(), d[0].numpy()
        # slab intersection with [-half, half]^3
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (-half - o) / d
            t1 = (half - o) / d
        tmin = np.nanmax(np.minimum(t0, t1), axis=1)
        tmax = np.nanmin(np.maximum(t0, t1), axis=1)
        hit = (tmax > tmin) & (tmax > 0)
        t_hit = np.where(hit, np.maximum(tmin, 0), np.inf)
        p_hit = o + d * t_hit[:, None]
        axis = np.argmax(np.abs(p_hit), axis=1)
        img = np.ones((h * w, 3), np.float32)
        for ax, alb in FACE_ALBEDO.items():
            sel = hit & (axis == ax)
            ndl = np.clip(np.abs(d[sel, ax]) / np.linalg.norm(d[sel], axis=1), 0.2, 1)
            img[sel] = np.asarray(alb) * ndl[:, None]
        alpha = hit.astype(np.float32)
        images.append(np.concatenate([img, alpha[:, None]], 1).reshape(h, w, 4))
        poses.append(c2w)
    return np.stack(images), np.stack(poses)


def cube_config(steps: int, n_coarse: int, n_importance: int, fused: bool,
                save_dir: str = "logs/validate_cube"):
    """The JAX tool's ``FrameworkConfig``, with the fused kernels on when
    ``fused``."""
    from intrinsicnerf_tpu_torch.config import ExperimentConfig, FrameworkConfig, LoggingConfig
    from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
    from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
    from intrinsicnerf_tpu_torch.train.step import TrainConfig

    return FrameworkConfig(
        experiment=ExperimentConfig(save_dir=save_dir, dataset_type="blender",
                                    enable_semantic=False, enable_depth=False,
                                    convention="opengl"),
        mlp=MLPConfig(pos_scalar_factor=1.0, compute_dtype=torch.bfloat16,
                      use_fused_kernel=fused),
        render=RenderConfig(n_coarse=n_coarse, n_importance=n_importance, perturb=1.0,
                            raw_noise_std=0.0, white_bkgd=True),
        train=TrainConfig(n_rays=512, lrate=5e-4, lrate_decay=250e3, n_iters=steps,
                          mask_mode="mask"),
        logging=LoggingConfig(step_log_tfb=500, step_save_ckpt=10**9, step_vis_train=10**9,
                              step_val=10**9),
        depth_range=(2.0, 6.0),
        precrop_iters=300,
    )


def cube_data(views: int, res: int, n_test: int = 2) -> BlenderData:
    images, poses = raytrace_cube_views(views, res)
    held_out = np.arange(views - n_test, views)
    return BlenderData(images=images, poses=poses,
                       render_poses=spherical_render_poses(8, radius=4.0), h=res, w=res,
                       focal=res * 1.2, i_split=[np.arange(views - n_test), held_out, held_out])


def run(steps=3000, res=64, views=60, n_coarse=64, n_importance=64, device="cuda",
        save_dir="logs/validate_cube") -> dict:
    """Train on the cube and return the held-out PSNR and the rate."""
    from intrinsicnerf_tpu_torch.core.metrics import psnr_np
    from intrinsicnerf_tpu_torch.train.prepare import prepare_blender_bundle
    from intrinsicnerf_tpu_torch.train.trainer import Trainer, make_object_sample_fn

    dev = torch.device(device)
    cfg = cube_config(steps, n_coarse, n_importance, dev.type == "cuda", save_dir)
    bundle, _ = prepare_blender_bundle(cfg, cube_data(views, res), device=dev)
    with Trainer(cfg, bundle, device=dev,
                 sample_fn=make_object_sample_fn(cfg, bundle)) as trainer:
        t0 = time.time()
        trainer.fit(progress=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        print(f"{steps} steps in {dt:.1f}s = {steps / dt:.1f} steps/s")
        gt = bundle.test_gt["image"]
        psnrs, accs = [], []
        for i, view in enumerate(trainer.render_views(bundle.rays_test)):
            psnrs.append(psnr_np(view["rgb"], gt[i]))
            accs.append(float(view["acc"].mean()))
    return {"psnr": float(np.mean(psnrs)), "steps": steps, "steps_per_s": steps / dt,
            "seconds": dt, "mean_acc": float(np.mean(accs)),
            "fused": cfg.mlp.use_fused_kernel}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--views", type=int, default=60)
    parser.add_argument("--n_coarse", type=int, default=64)
    parser.add_argument("--n_importance", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--save_dir", type=str, default="logs/validate_cube")
    args = parser.parse_args(argv)
    result = run(args.steps, args.res, args.views, args.n_coarse, args.n_importance,
                 args.device, args.save_dir)
    print(json.dumps(result))
    if not result["psnr"] > PSNR_FLOOR:
        raise SystemExit(f"convergence check failed: {result}")
    print("CONVERGENCE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
