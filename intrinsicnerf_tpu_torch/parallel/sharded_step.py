"""The data-parallel training step.

Port of ``intrinsicnerf_tpu/parallel/sharded_step.py``.  Each rank holds
its shard of the training-image pools and samples its own ``n_rays``
pairs from its own generator, renders and computes its losses locally;
the gradients (after the packed state's mask, as the JAX step orders
them) and the logged loss terms are averaged over the group
(``train/step.py:make_train_step(group=...)``, the twin of
``axis_name``), so parameters, Adam's state and the cluster table stay
identical on every rank.  The global batch is ``n_rays * world`` pairs,
with the loss of a single run over that batch (a mean of per-rank means
over equal shards).

The JAX step folds its key with the device's index on the mesh; here
rank ``r`` draws from a generator seeded ``seed + 1 + r * 2**32``, so
rank 0 draws what a run with no group draws (``Trainer``'s ``seed + 1``)
and every other rank has a stream of its own.
"""

from __future__ import annotations

import torch

from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
from intrinsicnerf_tpu_torch.parallel.mesh import DataGroup
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
from intrinsicnerf_tpu_torch.train.step import TrainConfig, make_train_step

RANK_STRIDE = 1 << 32  # seeds of two ranks of one run never meet another run's


def rank_seed(seed: int, rank: int) -> int:
    """The training draws' seed of ``rank`` in a run seeded ``seed``."""
    return seed + 1 + rank * RANK_STRIDE


def rank_generator(seed: int, group: DataGroup) -> torch.Generator:
    """This rank's generator of training draws, on its device."""
    return torch.Generator(device=group.device).manual_seed(rank_seed(seed, group.rank))


def make_sharded_train_step(mcfg: MLPConfig, rcfg: RenderConfig, tcfg: TrainConfig, h: int,
                            w: int, group: DataGroup, sample_fn=None, noise_fn=None):
    """``step_fn(state, pools, table, w_c, generator) -> LossReport`` of
    this rank: the name the JAX package gives ``make_train_step`` with the
    group's all-reduces (what ``Trainer`` calls), on this
    rank's pools (``mesh.shard_pools``) and generator
    (:func:`rank_generator`); ``sample_fn`` / ``noise_fn`` as there."""
    return make_train_step(mcfg, rcfg, tcfg, h, w, sample_fn=sample_fn, noise_fn=noise_fn,
                           group=group)
