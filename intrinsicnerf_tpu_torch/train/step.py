"""Training-step configuration (port of ``intrinsicnerf_tpu/train/step.py``).

The step function itself comes with the training slice of the port."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_rays: int = 512  # sampled pixels; the batch is 2x this after pairing
    lrate: float = 5e-4
    lrate_decay: float = 250e3
    n_iters: int = 200_000
    # loss weights (scene defaults from SSR_room0_config.yaml)
    wgt_sem: float = 4e-2
    w_chroma: float = 1.0
    w_n: float = 0.01  # reflect sparsity
    w_f: float = 0.005  # far reflect
    w_s: float = 1.0  # shading smooth (object configs override)
    w_res1: float = 1.0
    w_res2: float = 0.02
    w_i1: float = 0.1
    w_i2: float = 0.01
    residual_switch: int = 100_000
    intensity_switch: int = 50_000
    no_cluster: bool = False
    no_semantic_tree: bool = False
    no_intrinsic_loss: bool = False
    mask_mode: str = "label"  # "label" (scene) | "mask" (object)
    steps_per_call: int = 1
