"""The data-parallel group, its collectives, and pool sharding.

Port of ``intrinsicnerf_tpu/parallel/mesh.py``.  In place of a 1-D
``data`` mesh the port has a :class:`DataGroup`: this process's rank, the
world size, the backend, the device and the ``torch.distributed`` process
group, one process per GPU.  Parameters, Adam's state and the cluster
table are replicated; the training-image pools are sharded over the ranks
by image, so each rank samples its own ray pairs from its own images; the
hot path's only collectives are the train step's two all-reduces (the
gradients, and the logged loss terms).

The collectives the step and the sharded render run go through the
wrappers here (``reduce_grads``, ``reduce_terms``, ``all_gather_rows``),
each of which counts its calls as the kernel wrappers count launches:
``.launches`` for a collective run, ``.captured`` for one recorded into a
CUDA graph.  An all-reduce over one rank may launch no device work at
all, so the count is kept here and not read from a trace.  Without a
process group (a single process that asked for none) the group has world
1 and these run no collective and count nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.parallel.distributed import backend_for


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One process's place in a data-parallel run.  ``buffers`` keeps the
    flat buffers the step's collectives run over, made once and reused,
    so a CUDA graph that captured them reads the same memory on every
    replay."""

    rank: int
    world: int
    backend: Optional[str]  # "nccl", "gloo", or None without a process group
    device: torch.device
    process_group: Optional[object] = None
    buffers: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def lead(self) -> bool:
        """Whether this process owns file IO."""
        return self.rank == 0


def make_group(device="cuda") -> DataGroup:
    """The data-parallel group of this process on ``device``: the default
    process group when one is initialised, else a group of one process
    with no collectives.  A process group whose backend does not fit the
    device (gloo under a CUDA trainer, NCCL under a host one) raises."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return DataGroup(0, 1, None, dev)
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise RuntimeError(f"a {dev.type} trainer needs the {backend_for(dev)} backend; "
                           f"the process group was started with {backend}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataGroup(dist.get_rank(), dist.get_world_size(), backend, dev, dist.group.WORLD)


def _count(wrapper) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def _buffer(group: DataGroup, name: str, n: int, like: torch.Tensor) -> torch.Tensor:
    buf = group.buffers.get(name)
    if buf is None or buf.numel() != n or buf.dtype != like.dtype or buf.device != like.device:
        buf = group.buffers[name] = torch.empty(n, dtype=like.dtype, device=like.device)
    return buf


def _all_reduce_mean_(group: DataGroup, flat: torch.Tensor) -> None:
    # gloo has no ReduceOp.AVG: the sum, then one division (exact at world 1)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.process_group)
    flat.div_(group.world)


def reduce_grads(group: DataGroup, params: List[torch.Tensor]) -> None:
    """Average ``params``' gradients over the group with one all-reduce:
    the gradients are copied into one flat buffer of the group, reduced,
    divided by the world size, and each ``.grad`` becomes its view of the
    buffer."""
    if group.process_group is None:
        return
    grads = [p.grad for p in params]
    flat = _buffer(group, "grads", sum(g.numel() for g in grads), grads[0])
    torch.cat([g.reshape(-1) for g in grads], out=flat)
    _count(reduce_grads)
    _all_reduce_mean_(group, flat)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def reduce_terms(group: DataGroup, terms: List[torch.Tensor]) -> List[torch.Tensor]:
    """The 0-dim loss terms averaged over the group with one all-reduce of
    their stack (a copy: the buffer is reused by the next step)."""
    if group.process_group is None:
        return terms
    flat = _buffer(group, "terms", len(terms), terms[0])
    torch.stack(terms, out=flat)
    _count(reduce_terms)
    _all_reduce_mean_(group, flat)
    return list(flat.clone().unbind(0))


def all_gather_rows(group: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along the first axis in
    rank order, on every rank; ``all_gather_into_tensor`` under NCCL, a
    list ``all_gather`` under gloo (which has only that, on host tensors)."""
    if group.process_group is None:
        return x
    x = x.contiguous()
    _count(all_gather_rows)
    if group.backend == "nccl":
        out = x.new_empty((group.world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group.process_group)
        return out
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x, group=group.process_group)
    return torch.cat(parts)


for _w in (reduce_grads, reduce_terms, all_gather_rows):
    _w.launches = _w.captured = 0
del _w


@torch.no_grad()
def replicate(group: DataGroup, state):
    """Broadcast a ``TrainState`` from rank 0 in place: every parameter,
    every Adam tensor (moments and step counts) and the device step
    counter, so the ranks start from one state whatever each loaded or
    drew.  Returns ``state``."""
    if group.process_group is None:
        return state
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    tensors = list(params) + [state.step_t]
    for p in params:
        tensors += list(state.optimizer.state.get(p, {}).values())
    for t in tensors:
        buf = t if t.device == group.device else t.to(group.device)
        dist.broadcast(buf, src=0, group=group.process_group)
        if buf is not t:
            t.copy_(buf)
    torch.autograd.graph.increment_version(params)  # the models' packed operands are kept by version
    state.step = int(state.step_t)
    return state


def _replicated_leaves(pools) -> frozenset:
    """Pool fields that replicate instead of sharding by image
    (``PosePools.dirs_cam`` is shared by every image)."""
    from intrinsicnerf_tpu_torch.train.step import PosePools

    return frozenset(("dirs_cam",)) if isinstance(pools, PosePools) else frozenset()


def pool_specs(pools):
    """Per field of a ``DataPools`` or ``PosePools``: ``"shard"`` (split
    by image over the ranks), ``"replicate"`` or None (an absent field),
    the twin of the JAX ``PartitionSpec`` tree."""
    rep = _replicated_leaves(pools)
    return type(pools)(**{f: None if getattr(pools, f) is None
                          else ("replicate" if f in rep else "shard")
                          for f in type(pools)._fields})


def shard_pools(group: DataGroup, pools):
    """This rank's pools on its device: each image-axis field keeps its
    contiguous slice of ``[I / world]`` images (``I`` must divide the
    world size), the shared fields stay whole."""
    out = {}
    for f, spec in zip(type(pools)._fields, pool_specs(pools)):
        x = getattr(pools, f)
        if spec == "shard":
            per = x.shape[0] // group.world
            if per * group.world != x.shape[0]:
                raise ValueError(f"{f}: {x.shape[0]} images do not split over {group.world} "
                                 "ranks (pad them with pad_images_to_multiple first)")
            x = x[group.rank * per:(group.rank + 1) * per]
        out[f] = None if x is None else x.to(group.device)
    return type(pools)(**out)


def pad_images_to_multiple(pools, n: int):
    """Repeat leading images so the image count divides ``n`` (wrap-around,
    as the JAX package pads; duplicates only shift the sampling
    distribution a little).  Shared fields are left as they are."""
    rep = _replicated_leaves(pools)

    def pad(x):
        if x is None:
            return None
        r = (-x.shape[0]) % n
        if r == 0:
            return x
        reps = [x, x[: min(r, x.shape[0])]]
        while sum(a.shape[0] for a in reps) < x.shape[0] + r:
            reps.append(x[: x.shape[0] + r - sum(a.shape[0] for a in reps)])
        return torch.cat(reps, 0)

    return type(pools)(**{f: getattr(pools, f) if f in rep else pad(getattr(pools, f))
                          for f in type(pools)._fields})
