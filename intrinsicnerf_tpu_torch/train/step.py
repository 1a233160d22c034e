"""The scene-level training step: sample -> render -> losses -> Adam.

Port of ``intrinsicnerf_tpu/train/step.py:make_train_step``:

- total loss = img (coarse + fine levels)
  + wgt_sem * CE(sem logits, label - 1, ignore -1) * sem_flag
  + w_chroma * chroma + w_res(step) * residual + w_n * reflect sparsity
  + w_s * shading smooth + w_f * far reflect + w_i(step) * intensity
  + w_c * mse(albedo, cluster target), on both levels;
- the cluster target is computed without gradient from the fine albedo
  and the argmax of the fine semantic logits;
- Adam (b1 0.9, b2 0.999, eps 1e-8, as optax's) over both levels with
  the exponentially decayed LR read at the pre-update step.

The state is the coarse and fine models and one ``torch.optim.Adam``.
Where :func:`packs_state` holds (the fused kernels take the
configuration), the models are ``PackedMLP``s, the twin of the JAX
packed state: Adam updates the kernels' flat weight and bias buffers,
and the step multiplies their gradients by the 0/1 mask of the real
parameter slots (``ops/fused_mlp.py:packed_grad_masks``) before the
update, as the JAX step does, so the padded slots keep zero moments and
never move.  Elsewhere they are ``IntrinsicMLP``s with the reference
``nn.Linear`` parameters.  Adam being elementwise, both layouts take the
same steps from the same weights.  All random draws come from the
``torch.Generator`` handed to the step.

With a data-parallel group (``make_train_step(group=...)``, the twin of
the JAX ``axis_name``) the step averages the masked gradients over the
group in one all-reduce before Adam, and the logged loss terms in one
more (``parallel/mesh.py``); the report is built from the averaged terms.

Everything the step reads that changes from step to step lives on the
device: the step count (``TrainState.step_t``), from which the step
computes the LR and the loss-weight switches, and the cluster weight
``w_c``.  So one step body serves both modes of :func:`make_multi_step`:
K steps as a Python loop, and K steps captured once as a CUDA graph and
replayed, with the same arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.cluster.assign import ClusterTable, dest_color
from intrinsicnerf_tpu_torch.core.losses import (
    compute_intrinsic_losses,
    img2mse,
    mse2psnr,
    semantic_cross_entropy,
)
from intrinsicnerf_tpu_torch.data.samplers import sample_ray_pairs
from intrinsicnerf_tpu_torch.models.mlp import MLP, IntrinsicMLP, MLPConfig, PackedMLP, fuses
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.parallel.mesh import reduce_grads, reduce_terms
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, draw_train_noise, render_rays
from intrinsicnerf_tpu_torch.train.schedules import loss_weight_schedule, make_lr_schedule


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


@dataclasses.dataclass
class TrainState:
    """Mutable training state: the step updates it in place.  ``step`` is
    the host's count of steps taken; ``step_t`` the device's (0-dim
    int64 on the parameters' device, made from ``step`` when not given),
    which the step reads and advances."""

    step: int
    model_coarse: MLP
    model_fine: Optional[MLP]
    optimizer: torch.optim.Adam
    step_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step_t is None:
            dev = next(self.model_coarse.parameters()).device
            self.step_t = torch.tensor(self.step, dtype=torch.int64, device=dev)


class DataPools(NamedTuple):
    """Device-resident training data: per-image ray and gt pools."""

    rays: torch.Tensor  # [I, H*W, 11]
    rgb: torch.Tensor  # [I, H*W, 3]
    depth: Optional[torch.Tensor] = None  # [I, H*W]
    semantic: Optional[torch.Tensor] = None  # [I, H*W] labels (0=void) or mask
    mask_ids: Optional[torch.Tensor] = None  # [I]


class PosePools(NamedTuple):
    """Object-pipeline pools: rays built on the fly from the poses (O(HW)
    instead of O(I*HW*11) memory)."""

    dirs_cam: torch.Tensor  # [H*W, 3]
    poses: torch.Tensor  # [I, 4, 4]
    rgb: torch.Tensor  # [I, H*W, 3]
    mask: Optional[torch.Tensor] = None  # [I, H*W] object mask (alpha)


class LossReport(NamedTuple):
    total: torch.Tensor
    img_coarse: torch.Tensor
    img_fine: torch.Tensor
    psnr_coarse: torch.Tensor
    psnr_fine: torch.Tensor
    semantic: torch.Tensor
    chroma: torch.Tensor
    residual: torch.Tensor
    reflect_sparsity: torch.Tensor
    shading_smooth: torch.Tensor
    far_reflect: torch.Tensor
    intensity: torch.Tensor
    reflect_cluster: torch.Tensor


def packs_state(mcfg: MLPConfig) -> bool:
    """Whether the training state stores kernel-packed weights: where the
    fused kernels take the configuration (``models/mlp.py:fuses``, the
    eligibility ``eval_points`` applies), as the JAX ``packs_state``."""
    return fuses(mcfg)


def create_train_state(
    mcfg: MLPConfig,
    tcfg: TrainConfig,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    with_fine: bool = True,
    packed: Optional[bool] = None,
) -> TrainState:
    """Coarse and fine models initialised from ``generator`` (a CPU
    generator; default seed 0) on ``device`` (default ``"cuda"``, which
    raises without a GPU), and one Adam over both.  The models are
    ``PackedMLP``s where ``packed`` (default :func:`packs_state`) holds,
    else ``IntrinsicMLP``s; one generator gives the same weights in both.
    On the card Adam is ``capturable`` (its step counts and LR stay on the
    device, so a CUDA graph can hold its update); the host's Adam does
    not take that option."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = PackedMLP if (packs_state(mcfg) if packed is None else packed) else IntrinsicMLP
    model_c = model(mcfg, device=dev, generator=g)
    model_f = model(mcfg, device=dev, generator=g) if with_fine else None
    params = list(model_c.parameters()) + (list(model_f.parameters()) if with_fine else [])
    opt = torch.optim.Adam(params, lr=tcfg.lrate, betas=(0.9, 0.999), eps=1e-8,
                           capturable=dev.type == "cuda")
    return TrainState(step=0, model_coarse=model_c, model_fine=model_f, optimizer=opt)


def snapshot_state(state: TrainState, generator: Optional[torch.Generator] = None) -> dict:
    """Copies, on the device, of everything a step changes: parameters,
    Adam's state (None for a parameter that has none yet), both step
    counts and the generator's state."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    opt_state = state.optimizer.state
    return {
        "params": [p.detach().clone() for p in params],
        "adam": [{k: v.clone() for k, v in opt_state[p].items()} if p in opt_state else None
                 for p in params],
        "step": state.step,
        "step_t": state.step_t.clone(),
        "generator": generator.get_state() if generator is not None else None,
    }


@torch.no_grad()
def restore_state(state: TrainState, snap: dict,
                  generator: Optional[torch.Generator] = None) -> None:
    """Put ``snap`` back into ``state``'s own tensors (a CUDA graph that
    holds them sees the restored values).  Adam state made after the
    snapshot is zeroed, which is the state a fresh Adam starts from."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    opt_state = state.optimizer.state
    for p, saved, adam in zip(params, snap["params"], snap["adam"]):
        p.copy_(saved)
        for k, v in opt_state.get(p, {}).items():
            if adam is None:
                v.zero_()
            else:
                v.copy_(adam[k])
    state.step = snap["step"]
    state.step_t.copy_(snap["step_t"])
    if generator is not None:
        generator.set_state(snap["generator"])


LEVEL_TERMS = ("img", "sem", "chroma", "residual", "reflect_sparsity", "shading_smooth",
               "far_reflect", "intensity", "cluster")


def _level_terms(t: dict) -> list:
    """One level's loss terms as 0-dim tensors, in ``LEVEL_TERMS`` order."""
    intr = t["intr"]
    return [t["img"], t["sem"], intr.chroma, intr.residual, intr.reflect_sparsity,
            intr.shading_smooth, intr.far_reflect, intr.intensity, t["cluster"]]


def make_train_step(
    mcfg: MLPConfig,
    rcfg: RenderConfig,
    tcfg: TrainConfig,
    h: int,
    w: int,
    sample_fn=None,
    noise_fn=None,
    group=None,
):
    """The step ``step_fn(state, pools, table, w_c, generator) ->
    LossReport``.  It updates ``state`` in place, leaves this step's
    gradients in the parameters' ``.grad`` (masked, on packed state), and
    returns the loss terms
    as detached 0-dim tensors on the device (no host sync).  ``w_c`` is
    a number or a 0-dim float32 tensor on the device; the LR and the
    loss-weight switches are read from ``state.step_t``.

    ``sample_fn(generator, pools, step) -> RayBatch`` overrides the
    paired pool sampler (``step`` is the device counter ``state.step_t``,
    read before this step advances it, so a graph replay sees each step's
    count, as the traced step of the JAX scan does); ``noise_fn(
    generator, n_rays) -> dict`` overrides ``draw_train_noise`` (both
    hooks let callers inject fixed draws).  ``group`` (a
    ``parallel.mesh.DataGroup``) averages the gradients and the loss terms
    over its ranks; the step keeps it in ``step_fn.group``."""
    lr_schedule = make_lr_schedule(tcfg.lrate, tcfg.lrate_decay)

    def loss_terms(maps, batch, w_res, w_i, cluster_target, w_c):
        img = img2mse(maps.rgb, batch.rgb)
        zero = img.new_zeros(())
        sem = zero
        if mcfg.enable_semantic and maps.sem_logits is not None:
            sem = semantic_cross_entropy(maps.sem_logits, batch.semantic) * batch.sem_flag
        pair_label = (batch.semantic if batch.semantic is not None
                      else torch.ones(batch.rgb.shape[0], dtype=batch.rgb.dtype,
                                      device=batch.rgb.device))
        intr = compute_intrinsic_losses(maps.albedo, maps.shading, maps.residual, batch.rgb,
                                        pair_label, mask_mode=tcfg.mask_mode)
        cluster = img2mse(maps.albedo, cluster_target) if cluster_target is not None else zero
        if tcfg.no_intrinsic_loss:
            total = img + sem * tcfg.wgt_sem
        else:
            total = (
                img
                + sem * tcfg.wgt_sem
                + intr.chroma * tcfg.w_chroma
                + intr.residual * w_res
                + intr.reflect_sparsity * tcfg.w_n
                + intr.shading_smooth * tcfg.w_s
                + intr.far_reflect * tcfg.w_f
                + intr.intensity * w_i
            )
        total = total + cluster * w_c
        return {"img": img, "sem": sem, "intr": intr, "cluster": cluster, "total": total}

    def step_fn(state: TrainState, pools: DataPools, table: Optional[ClusterTable],
                w_c, generator: torch.Generator) -> LossReport:
        step_t = state.step_t
        if sample_fn is not None:
            batch = sample_fn(generator, pools, step_t)
        else:
            batch = sample_ray_pairs(generator, pools.rays, pools.rgb, h, w, tcfg.n_rays,
                                     depth_pool=pools.depth, sem_pool=pools.semantic,
                                     mask_ids=pools.mask_ids)
        n = batch.rays.shape[0]
        draws = (noise_fn(generator, n) if noise_fn is not None
                 else draw_train_noise(n, rcfg, generator, batch.rays.device))
        w_res, w_i = loss_weight_schedule(step_t, tcfg.w_res1, tcfg.w_res2, tcfg.w_i1,
                                          tcfg.w_i2, tcfg.residual_switch,
                                          tcfg.intensity_switch)
        w_c = torch.as_tensor(w_c, dtype=torch.float32, device=step_t.device)

        out = render_rays(state.model_coarse, state.model_fine, mcfg, batch.rays, rcfg,
                          train=True, **draws)
        fine = out.fine if out.fine is not None else out.coarse
        cluster_target = None
        if not tcfg.no_cluster and table is not None:
            with torch.no_grad():
                if mcfg.enable_semantic and fine.sem_logits is not None:
                    cls = torch.argmax(fine.sem_logits, dim=-1)
                else:
                    cls = torch.zeros(n, dtype=torch.long, device=batch.rays.device)
                cluster_target = dest_color(table, fine.albedo.detach(), cls)

        t_c = loss_terms(out.coarse, batch, w_res, w_i, cluster_target, w_c)
        t_f = (loss_terms(out.fine, batch, w_res, w_i, cluster_target, w_c)
               if out.fine is not None else None)
        total = t_c["total"] + (t_f["total"] if t_f is not None else 0.0)

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        total.backward()
        for model in (state.model_coarse, state.model_fine):
            if isinstance(model, PackedMLP):
                model.mask_grads()
        if group is not None:  # the mask first, then the mean, as the JAX step orders them
            reduce_grads(group, [p for g in opt.param_groups for p in g["params"]])
        lr = lr_schedule(step_t)  # the pre-update count, as optax reads it
        if lr.device.type == "cpu":
            lr = float(lr)  # the host's Adam takes a number
        for pg in opt.param_groups:
            pg["lr"] = lr
        opt.step()
        step_t.add_(1)
        state.step += 1

        # the logged terms: the total, then each level's (averaged over the group)
        terms = [total] + [v for t in (t_c, t_f) if t is not None for v in _level_terms(t)]
        terms = [v.detach() for v in terms]
        if group is not None:
            terms = reduce_terms(group, terms)
        c = dict(zip(LEVEL_TERMS, terms[1:]))
        f = dict(zip(LEVEL_TERMS, terms[1 + len(LEVEL_TERMS):])) if t_f is not None else None

        def both(name):
            return c[name] + f[name] if f is not None else c[name]

        zero = c["img"].new_zeros(())
        return LossReport(
            total=terms[0],
            img_coarse=c["img"],
            img_fine=f["img"] if f is not None else zero,
            psnr_coarse=mse2psnr(c["img"]),
            psnr_fine=mse2psnr(f["img"]) if f is not None else zero,
            semantic=both("sem"),
            chroma=both("chroma"),
            residual=both("residual"),
            reflect_sparsity=both("reflect_sparsity"),
            shading_smooth=both("shading_smooth"),
            far_reflect=both("far_reflect"),
            intensity=both("intensity"),
            reflect_cluster=both("cluster"),
        )

    step_fn.group = group
    return step_fn


def make_multi_step(step_fn, k: int):
    """``k`` training steps per call, with ``step_fn``'s signature; the
    last step's ``LossReport`` comes back (cadence-gated logging reads one
    report per block, and the trainer requires its cadences to be
    multiples of ``k``).  Port of the JAX ``make_multi_step`` (K steps in
    one ``lax.scan`` executable), which amortises the host's per-step
    dispatch.

    On CPU tensors the ``k`` steps run as a Python loop.  On the card they
    are captured once as one ``torch.cuda.CUDAGraph`` per set of static
    inputs (the pools, the table's tensors, ``w_c``, the generator and the
    training state's tensors) and replayed.  The capture first runs one
    eager step on a side stream (kernels built, Adam's state made) and
    puts the state and the generator back as they were, so the first
    call's steps are replays too.  Callers change ``w_c`` and the table by
    copying into the same tensors; ``w_c`` must then be a 0-dim float32
    tensor on the device, since a graph would hold a number as a
    constant.  The generator is registered with the graph, so every
    replay draws as the eager steps would and advances it as they do.
    A replay writes the parameters without PyTorch seeing it, so each
    replay bumps their version counters, as an in-place update does (the
    model's packed fused-kernel operands are kept by version).  A failed
    capture or replay raises.  The returned callable keeps ``k``
    in ``.k``, counts its replays in ``.replays`` and, in ``.replayed``,
    the kernel launches its replays made (``fm.LAUNCH_COUNTERS``' names:
    each replay adds what its graph recorded), which no wrapper counts."""
    if k < 1:
        raise ValueError(f"steps per call must be >= 1, got {k}")
    cache: Dict[str, object] = {"key": None, "graph": None, "out": None, "params": None,
                                "recorded": {}}

    def multi(state: TrainState, pools: DataPools, table: Optional[ClusterTable], w_c,
              generator: torch.Generator) -> LossReport:
        if state.step_t.device.type != "cuda":
            report = None
            for _ in range(k):
                report = step_fn(state, pools, table, w_c, generator)
            return report
        if not (torch.is_tensor(w_c) and w_c.dim() == 0 and w_c.device == state.step_t.device):
            raise ValueError("a graphed step needs w_c as a 0-dim tensor on the device, "
                             f"got {w_c!r}")
        if cache["key"] != _static_key(step_fn, state, pools, table, w_c, generator):
            cache["graph"] = cache["out"] = None  # free the old graph's memory first
            before = {name: c.captured for name, c in fm.LAUNCH_COUNTERS.items()}
            cache["graph"], cache["out"] = _capture(step_fn, k, state, pools, table, w_c,
                                                    generator)
            cache["recorded"] = {name: c.captured - before[name]
                                 for name, c in fm.LAUNCH_COUNTERS.items()}
            cache["key"] = _static_key(step_fn, state, pools, table, w_c, generator)
            cache["params"] = [p for g in state.optimizer.param_groups for p in g["params"]]
        cache["graph"].replay()
        torch.autograd.graph.increment_version(cache["params"])
        state.step += k
        multi.replays += 1
        for name, n in cache["recorded"].items():
            multi.replayed[name] += n
        return LossReport(*cache["out"].clone().unbind())

    multi.replays = 0
    multi.replayed = dict.fromkeys(fm.LAUNCH_COUNTERS, 0)
    multi.k = k
    return multi


def _static_key(step_fn, state, pools, table, w_c, generator) -> tuple:
    """What a captured graph holds by address: a new tensor anywhere
    here (a restored Adam state, a new table, a new buffer of the group's
    collectives) needs a new capture."""
    group = getattr(step_fn, "group", None)
    tensors = [*pools, *(table if table is not None else ()), w_c, state.step_t,
               *(group.buffers.values() if group is not None else ())]
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            tensors += [p, *state.optimizer.state.get(p, {}).values()]
    return (id(generator), *(t.data_ptr() if torch.is_tensor(t) else t for t in tensors))


def _capture(step_fn, k, state, pools, table, w_c, generator):
    """(graph, the last step's stacked report) of ``k`` steps."""
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError("a graphed step needs torch.cuda.CUDAGraph.register_generator_state "
                           f"(this PyTorch is {torch.__version__})")
    snap = snapshot_state(state, generator)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_fn(state, pools, table, w_c, generator)
    torch.cuda.current_stream().wait_stream(side)
    restore_state(state, snap, generator)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    state.optimizer.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        for _ in range(k):
            report = step_fn(state, pools, table, w_c, generator)
        out = torch.stack(list(report))
    state.step = snap["step"]  # capture ran nothing: only the replays count
    return graph, out
