"""Training schedules (port of ``intrinsicnerf_tpu/train/schedules.py``).

- exponential LR decay ``lr = lr0 * 0.1^(step / decay_steps)``, read at
  the pre-update step count, so step 0 trains at ``lr0`` (as
  ``optax.exponential_decay`` inside the JAX Adam).  The step sets the
  optimiser's ``lr`` by hand before each ``optimizer.step()``: a torch
  LR scheduler steps after the update and would be one step late;
- residual weight ``w_res1 -> w_res2`` after step 100k, intensity weight
  ``w_i1 -> w_i2`` after 50k (the switch steps themselves keep the first
  weight);
- cluster-loss weight and bandwidth factor anneal at each cluster rebuild.

The LR and the loss weights take the step as a Python int (a float
back) or as a 0-dim integer tensor, the training step's device counter
(a 0-dim float32 tensor back, on its device, computed as ``optax`` and
``jnp.where`` compute them in float32).  The step reads the tensor
form, so a CUDA graph replay reads the count the device holds, not one
baked in at capture.
"""

from __future__ import annotations

import torch


def make_lr_schedule(base_lr: float, decay_steps: float, decay_rate: float = 0.1):
    """``step -> base_lr * decay_rate ** (step / decay_steps)``."""

    def schedule(step):
        if torch.is_tensor(step):
            return base_lr * torch.pow(decay_rate, step.float() / decay_steps)
        return base_lr * decay_rate ** (step / decay_steps)

    return schedule


def loss_weight_schedule(
    step: int,
    w_res1: float,
    w_res2: float,
    w_i1: float,
    w_i2: float,
    residual_switch: int = 100_000,
    intensity_switch: int = 50_000,
):
    """(residual weight, intensity weight) at ``step``."""
    if torch.is_tensor(step):
        return (torch.where(step <= residual_switch, w_res1, w_res2).float(),
                torch.where(step <= intensity_switch, w_i1, w_i2).float())
    w_res = w_res1 if step <= residual_switch else w_res2
    w_i = w_i1 if step <= intensity_switch else w_i2
    return w_res, w_i


def cluster_anneal(global_step: int, vis_every: int, n_iters: int, b_f_cap: float = 1.0):
    """(w_c, b_f) at a cluster rebuild: with progress ``n``,
    ``w_c = min(0.1^(2-2n), 1)`` and ``b_f = min(0.5^(2-2n), cap)``."""
    denom = float(n_iters - vis_every * 2)
    n = float(global_step - vis_every) / denom if denom != 0 else 1.0
    w_c = min(0.1 ** (2.0 - 2.0 * n), 1.0)
    b_f = min(0.5 ** (2.0 - 2.0 * n), b_f_cap)
    return w_c, b_f
