"""Convergence gate of the port: the twin of ``tools_convergence_gate.py``.

Trains the port's scene CLI (``python -m intrinsicnerf_tpu_torch.train_scene``)
on the synthetic multi-object room of ``tools_make_synthetic_replica.py``
(10 classes, 38 flat albedos, thin structures; 60 frames at 160x120,
every 5th frame offset 2 held out) in three arms, with the JAX gate's
thresholds and checks:

- **main** (every loss): held-out PSNR / mIoU / total-acc floors, the
  palette (enough centres, and every albedo seen in the GT within
  ``drgb_tol`` of a centre in d_rgb space) and the scale-aligned albedo
  MAE against the generator's GT albedo;
- **no_intrinsic** (``no_intrinsic_loss`` + ``no_cluster``): the residual
  must absorb the scene and the albedo MAE must rise;
- **no_cluster** (priors on, cluster loss off): the albedo must be less
  piecewise-constant (higher TV) than in the main arm.

    python -m intrinsicnerf_tpu_torch.tools.convergence_gate --steps 10000

``--layers plain`` trains every arm on the MLP's plain PyTorch layers
(``use_fused_kernel: false``) instead of the hand-written kernels, so
that a result the kernels may cause can be told from one of the model.

Its runs go under ``logs/convergence_gate_torch`` and its JSON to
``logs/convergence_torch.json`` by default (never over a tracked
``CONVERGENCE_r*.json``); it exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import subprocess
import sys

import numpy as np

from intrinsicnerf_tpu_torch.tools.synthetic_replica import (
    REPO, repo_env, write_synthetic_replica)
from intrinsicnerf_tpu_torch.utils.image import imread

THRESHOLDS = {
    # calibrated on the hard scene at 10k steps (CONVERGENCE_r04.json)
    "psnr": 28.0,
    "miou": 0.85,
    "total_acc": 0.93,
    "residual_ratio": 5.0,
    "palette_centers": 40,
    "palette_recall": 0.60,
    "drgb_tol": 0.08,
    "albedo_mae": 0.16,
    "albedo_mae_ablation_ratio": 1.5,
}

TOTAL_FRAMES = 60
SPLIT_STEP = 5  # test ids = every 5th frame offset 2 (the CLI's default split)


def run_scene(cfg_path, tag, device, seed=0):
    args = ["--config_file", str(cfg_path), "--total_frames", str(TOTAL_FRAMES),
            "--split_step", str(SPLIT_STEP), "--no_progress", "--seed", str(seed)]
    proc = subprocess.run(
        [sys.executable, "-m", "intrinsicnerf_tpu_torch.train_scene", *args, "--device", device],
        capture_output=True, text=True, cwd=REPO, env=repo_env(), timeout=3600)
    sys.stderr.write(proc.stdout[-2000:] + "\n")
    if proc.returncode != 0:
        raise RuntimeError(f"{tag} run failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def read_test_metrics(save_dir):
    """The last Test/* scalars of the trainer's CSV log."""
    metrics = {}
    with open(os.path.join(save_dir, "tfb_logs", "scalars.csv")) as f:
        for _step, name, val in csv.reader(f):
            if name.startswith("Test/"):
                metrics[name[5:]] = float(val)
    return metrics


def _last_dir(save_dir, kind):
    dirs = sorted(glob.glob(os.path.join(save_dir, kind, "step_*")))
    if not dirs:
        raise FileNotFoundError(f"no {kind} under {save_dir}")
    return dirs[-1]


def _rgb01(path):
    return imread(path).astype(np.float32) / 255.0


def decomposition_stats(save_dir):
    """Mean |residual| and albedo TV of the rendered test views."""
    d = _last_dir(save_dir, "test_render")
    res = [float(imread(p).astype(np.float32).mean() / 255.0)
           for p in sorted(glob.glob(os.path.join(d, "residual_*.png")))]
    tvs = []
    for p in sorted(glob.glob(os.path.join(d, "albedo_*.png"))):
        a = _rgb01(p)
        tvs.append(float(np.abs(np.diff(a, axis=0)).mean() + np.abs(np.diff(a, axis=1)).mean()))
    if not (res and tvs):
        raise FileNotFoundError(f"missing decomposition renders in {d}")
    return float(np.mean(res)), float(np.mean(tvs))


def albedo_fidelity(save_dir, data_dir):
    """Scale-aligned MAE of the rendered test albedo against the GT
    albedo (each view aligned by its median per-pixel ratio)."""
    d = _last_dir(save_dir, "test_render")
    test_ids = [i for i in range(TOTAL_FRAMES) if i % SPLIT_STEP == 2]
    maes = []
    for k, p in enumerate(sorted(glob.glob(os.path.join(d, "albedo_*.png")))):
        got = _rgb01(p)
        gt = _rgb01(os.path.join(data_dir, "gt_albedo", f"albedo_{test_ids[k]}.png"))
        if got.shape != gt.shape:
            raise ValueError(f"render {got.shape} and GT {gt.shape} differ")
        m = gt.mean(-1) > 0.05
        scale = float(np.median(gt[m].sum(-1) / np.maximum(got[m].sum(-1), 1e-6)))
        scale = float(np.clip(scale, 0.25, 4.0))
        maes.append(float(np.abs(got * scale - gt)[m].mean()))
    if not maes:
        raise FileNotFoundError(f"missing albedo renders in {d}")
    return float(np.mean(maes))


def _map_drgb(rgb):
    s = np.maximum(rgb.sum(-1), 1e-6)
    return np.stack([s / 3.0 * 0.5, rgb[..., 1] / s, rgb[..., 2] / s], -1)


def check_cluster_palette(save_dir, data_dir):
    """Palette sanity and recall: every GT albedo colour seen in the train
    frames must lie within ``drgb_tol`` of a mean-shift centre."""
    cdir = os.path.join(_last_dir(save_dir, "train_render"), "cluster")
    with open(os.path.join(cdir, "clusters.json")) as f:
        n_cls = int(json.load(f)["class_num"])
    if n_cls < 2:
        raise ValueError(f"degenerate class_num {n_cls}")
    centers_all = []
    for c in range(n_cls):
        with open(os.path.join(cdir, f"c{c}", "config.json")) as f:
            centers = np.asarray(json.load(f).get("rgb_centers", []), np.float32)
        if centers.size:
            if centers.min() < -1e-6 or centers.max() > 1 + 1e-6:
                raise ValueError(f"class {c} centres outside [0, 1]")
            centers_all.append(centers)
    n_centers = int(sum(len(c) for c in centers_all))
    if n_centers < n_cls:
        raise ValueError(f"too few cluster centres ({n_centers})")
    with open(os.path.join(data_dir, "albedo_colors.json")) as f:
        palette = np.asarray(json.load(f)["albedos"], np.float32)
    train_ids = [i for i in range(TOTAL_FRAMES) if i % SPLIT_STEP != 2]
    counts = np.zeros(len(palette), np.int64)
    total_px = 0
    for i in train_ids[:: max(len(train_ids) // 12, 1)]:
        a = _rgb01(os.path.join(data_dir, "gt_albedo", f"albedo_{i}.png")).reshape(-1, 3)
        total_px += len(a)
        d2 = ((a[:, None, :] - palette[None, :, :]) ** 2).sum(-1)
        nearest = np.argmin(d2, axis=1)
        ok = d2[np.arange(len(a)), nearest] < 1e-3
        np.add.at(counts, nearest[ok], 1)
    observed = palette[counts / max(total_px, 1) >= 0.002]
    cen = np.concatenate(centers_all) if centers_all else np.zeros((0, 3))
    dist = np.sqrt(((_map_drgb(observed)[:, None, :] - _map_drgb(cen)[None, :, :]) ** 2)
                   .sum(-1)).min(axis=1)
    return {
        "class_num": n_cls,
        "total_centers": n_centers,
        "observed_gt_colors": int(len(observed)),
        "palette_recall": round(float((dist < THRESHOLDS["drgb_tol"]).mean()), 4),
        "recall_mean_dist": round(float(dist.mean()), 4),
    }


def make_cfg(workdir, data_dir, tag, steps, ablation="none", fused=True):
    import yaml

    save_dir = os.path.join(workdir, f"logs_{tag}")
    cfg = {
        "experiment": {"save_dir": save_dir, "dataset_dir": data_dir, "dataset_type": "replica",
                       "convention": "opencv", "width": 160, "height": 120,
                       "enable_semantic": True, "enable_depth": True},
        "model": {"netdepth": 8, "netwidth": 256, "netdepth_fine": 8, "netwidth_fine": 256,
                  "chunk": "1024*32", "netchunk": "1024*32"},
        "render": {"N_rays": "32*16", "N_samples": 64, "N_importance": 128, "perturb": 1,
                   "use_viewdirs": True, "multires": 10, "multires_views": 4,
                   "raw_noise_std": 1, "test_viz_factor": 1, "depth_range": [0.1, 10.0],
                   "white_bkgd": False},
        "train": {"lrate": "5e-4", "lrate_decay": "250e3", "N_iters": steps, "wgt_sem": 0.04,
                  "w_n": 0.01, "w_f": 0.005, "w_i1": 0.1, "w_i2": 0.01,
                  "no_cluster": ablation in ("no_intrinsic", "no_cluster"),
                  "no_semantic_tree": False, "no_intrinsic_loss": ablation == "no_intrinsic"},
        "logging": {"step_log_print": 1000, "step_log_tfb": 1000,
                    "step_save_ckpt": steps,
                    "step_val": steps, "step_vis_train": max(steps // 4, 1)},
    }
    if not fused:
        cfg["use_fused_kernel"] = False
    path = os.path.join(workdir, f"cfg_{tag}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, save_dir


def _device_name(device: str) -> str:
    import torch

    if device.startswith("cuda"):
        from intrinsicnerf_tpu_torch.tools.fwd_probe import card_name

        return f"cuda:{torch.cuda.get_device_name(0)} ({card_name()})"
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--out", type=str, default=os.path.join(REPO, "logs", "convergence_torch.json"))
    ap.add_argument("--workdir", type=str,
                    default=os.path.join(REPO, "logs", "convergence_gate_torch"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the CLI's init / training draws seed, for every arm")
    ap.add_argument("--layers", choices=("fused", "plain"), default="fused",
                    help="train on the MLP's fused kernels or on its plain layers")
    ap.add_argument("--reuse", action="store_true",
                    help="re-stamp the JSON from the runs already in --workdir")
    args = ap.parse_args(argv)
    out_path = os.path.abspath(args.out)
    if (os.path.dirname(out_path) == REPO
            and os.path.basename(out_path).startswith("CONVERGENCE_r")):
        raise SystemExit(f"{out_path}: the JAX gate's tracked stamps are not overwritten")
    from intrinsicnerf_tpu_torch import resolve_device

    resolve_device(args.device)  # no GPU and no --device cpu: fail before training
    workdir = args.workdir
    print(f"workdir: {workdir}")
    data_dir = os.path.join(workdir, "data")
    if not args.reuse:
        write_synthetic_replica(data_dir, TOTAL_FRAMES, 160, 120)

    arms = {}
    for tag, ablation in (("main", "none"), ("no_intrinsic", "no_intrinsic"),
                          ("no_cluster", "no_cluster")):
        cfg_path, save_dir = make_cfg(workdir, data_dir, tag, args.steps, ablation,
                                      fused=args.layers == "fused")
        if not args.reuse:
            run_scene(cfg_path, tag, args.device, args.seed)
        arms[tag] = (cfg_path, save_dir)

    dir_main, dir_abl, dir_nc = (arms[t][1] for t in ("main", "no_intrinsic", "no_cluster"))
    metrics = read_test_metrics(dir_main)
    palette = check_cluster_palette(dir_main, data_dir)
    res_main, tv_main = decomposition_stats(dir_main)
    mae_main = albedo_fidelity(dir_main, data_dir)
    res_abl, tv_abl = decomposition_stats(dir_abl)
    mae_abl = albedo_fidelity(dir_abl, data_dir)
    _res_nc, tv_nc = decomposition_stats(dir_nc)
    mae_nc = albedo_fidelity(dir_nc, data_dir)

    from intrinsicnerf_tpu_torch.config import from_yaml

    mlp = from_yaml(arms["main"][0]).mlp
    result = {
        "steps": args.steps,
        "seed": args.seed,
        "layers": args.layers,
        "scene": "hard multi-object room (10 classes, 38 albedos, thin structures)",
        "device": _device_name(args.device),
        "fused_kernel_active": bool(mlp.use_fused_kernel and (mlp.depth, mlp.width) == (8, 256)
                                    and args.device.startswith("cuda")),
        "metrics": {k: round(v, 4) for k, v in metrics.items()},
        "cluster_palette": palette,
        "albedo_mae_main": round(mae_main, 5),
        "albedo_mae_no_intrinsic": round(mae_abl, 5),
        "albedo_mae_no_cluster": round(mae_nc, 5),
        "albedo_tv_no_cluster": round(tv_nc, 5),
        "residual_mean_main": round(res_main, 5),
        "residual_mean_no_intrinsic": round(res_abl, 5),
        "residual_ratio": round(res_abl / max(res_main, 1e-6), 2),
        "albedo_tv_main": round(tv_main, 5),
        "albedo_tv_no_intrinsic": round(tv_abl, 5),
        "thresholds": THRESHOLDS,
    }
    checks = {
        "psnr": metrics.get("psnr", 0.0) > THRESHOLDS["psnr"],
        "miou": metrics.get("miou", 0.0) > THRESHOLDS["miou"],
        "total_acc": metrics.get("total_acc", 0.0) > THRESHOLDS["total_acc"],
        "residual_ratio": res_abl / max(res_main, 1e-6) > THRESHOLDS["residual_ratio"],
        "palette_centers": palette["total_centers"] >= THRESHOLDS["palette_centers"],
        "palette_recall": palette["palette_recall"] >= THRESHOLDS["palette_recall"],
        "albedo_mae": mae_main < THRESHOLDS["albedo_mae"],
        "intrinsic_improves_albedo": mae_abl > mae_main * THRESHOLDS["albedo_mae_ablation_ratio"],
        "cluster_flattens_albedo": tv_main < tv_nc,
    }
    result["checks"] = checks
    result["pass"] = all(checks.values())
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(json.dumps(result, indent=2))
    if not result["pass"]:
        print(f"convergence gate FAILED: {checks}")
        return 1
    print("CONVERGENCE GATE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
