"""The port's training bench: rays per second through the whole step.

Twin of the JAX package's ``bench.py``, with its workload: the Replica
scene step (512 sampled pixels paired to 1,024 rays, 64 coarse + 128
fine samples a ray, the 8x256 fused MLPs with a 27-class semantic head,
bf16), the full loss stack with the cluster term against a live anchor
table (one mean-shift cluster of 2,000 seeded colours for every class,
2,048 anchors a class), ``w_c`` 0.01, and Adam with the decayed LR, on
16 synthetic 240x320 pools.

``--steps_per_call K`` runs K steps per call: one eager step at K = 1,
else K steps captured once as a CUDA graph and replayed
(``train/step.py:make_multi_step``), as the trainer's ``steps_per_call``
does.  Five warm-up calls (the first builds the kernels and, at K > 1,
captures the graph), then five timed windows of 200 steps, each ended
by reading one loss back to the host.  It prints one JSON line:
``train_rays_per_s_per_chip`` as the median of the windows, their
spread, the median window's ms per step, K, and the device with its
power limit.  Run it on the card from the root of a checkout:

    python -m intrinsicnerf_tpu_torch.tools.bench [--steps_per_call K] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.cluster.manager import ClusterManager, build_cluster
from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
from intrinsicnerf_tpu_torch.train.step import (
    DataPools, TrainConfig, create_train_state, make_multi_step, make_train_step)

H, W, N_IMG, N_CLASSES = 240, 320, 16, 27
MLP = MLPConfig(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=N_CLASSES,
                compute_dtype=torch.bfloat16, use_fused_kernel=True)
RENDER = RenderConfig(n_coarse=64, n_importance=128, perturb=1.0, raw_noise_std=1.0)
TRAIN = TrainConfig(n_rays=512)
W_C = 0.01
UNIT = "rays/s (fwd+bwd, 192 samples/ray, full loss stack; median of the windows)"


def make_synthetic_pools(h, w, n_img, n_classes, device, seed=0) -> DataPools:
    """Identity-pose cameras pulled back along -z with uniform-noise ground
    truth, at the Replica scene's shapes (hfov 90): the port's copy of
    ``bench_common.make_synthetic_pools``."""
    rng = np.random.default_rng(seed)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1))
    c2ws[:, 2, 3] = -3.0 - 0.05 * np.arange(n_img)
    fx = w / 2.0
    rays = create_rays(torch.from_numpy(c2ws).to(device), h, w, fx, fx, (w - 1) / 2,
                       (h - 1) / 2, 0.1, 10.0)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return DataPools(
        rays=rays,
        rgb=dev(rng.uniform(size=(n_img, h * w, 3)).astype(np.float32)),
        depth=dev(rng.uniform(1, 5, size=(n_img, h * w)).astype(np.float32)),
        semantic=dev(rng.integers(0, n_classes, size=(n_img, h * w))),
        mask_ids=torch.ones((n_img,), dtype=torch.int32, device=device),
    )


def make_workload(device, seed=0, mcfg=MLP, rcfg=RENDER, tcfg=TRAIN, h=H, w=W, n_img=N_IMG):
    """(step_fn, state, pools, table, w_c, generator) of the bench's step
    on ``device``, everything drawn from ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_classes = mcfg.num_semantic_classes
    pools = make_synthetic_pools(h, w, n_img, n_classes, dev, seed=seed)
    cluster = build_cluster(np.clip(rng.uniform(0.1, 0.9, size=(2000, 3)), 0, 1),
                            band_factor=1.0)
    table = ClusterManager(class_num=n_classes, clusters=[cluster] * n_classes).to_table(
        anchors_per_class=2048, device=dev)
    state = create_train_state(mcfg, tcfg, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    step_fn = make_train_step(mcfg, rcfg, tcfg, h, w)
    w_c = torch.tensor(W_C, dtype=torch.float32, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 7)
    return step_fn, state, pools, table, w_c, generator


def measure(step_fn, state, pools, table, w_c, generator, rays_per_step: int,
            steps_per_call: int = 8, windows: int = 5, steps_per_window: int = 200,
            warmup: int = 5) -> dict:
    """Time ``windows`` windows of ``steps_per_window`` steps after
    ``warmup`` calls; each window ends by reading one loss to the host."""
    k = steps_per_call
    if steps_per_window % k:
        raise ValueError(f"steps_per_call {k} must divide the window's {steps_per_window} steps")
    step = step_fn if k == 1 else make_multi_step(step_fn, k)
    for _ in range(warmup):
        report = step(state, pools, table, w_c, generator)
    float(report.total)
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps_per_window // k):
            report = step(state, pools, table, w_c, generator)
        float(report.total)
        rates.append(rays_per_step * steps_per_window / (time.perf_counter() - t0))
    median = float(np.median(rates))
    return {
        "metric": "train_rays_per_s_per_chip",
        "value": median,
        "unit": UNIT,
        "spread": {"windows": windows, "steps_per_window": steps_per_window,
                   "min": min(rates), "max": max(rates),
                   "iqr": float(np.percentile(rates, 75) - np.percentile(rates, 25))},
        "ms_per_step": 1e3 * rays_per_step / median,
        "steps_per_call": k,
        "last_total": float(report.total),
    }


def device_info(device) -> dict:
    """The device's name and, for a card, its power limit as
    ``nvidia-smi`` reports it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"name": torch.cuda.get_device_name(index),
            "power_limit": out[index].split(",")[-1].strip() if len(out) > index else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload = make_workload("cuda", args.seed)
    result = measure(*workload, rays_per_step=2 * TRAIN.n_rays,
                     steps_per_call=args.steps_per_call)
    result["device"] = device_info("cuda")
    result["seed"] = args.seed
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
