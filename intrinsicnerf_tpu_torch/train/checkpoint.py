"""Checkpoints in the original ``.ckpt`` layout, saved off the training loop.

Port of ``intrinsicnerf_tpu/train/checkpoint.py``, with ``torch.save`` in
place of Orbax.  Each save writes ``<ckpt_dir>/{step:06d}.ckpt``, a dict
with the original scene trainer's keys (``global_step``,
``network_coarse_state_dict``, ``network_fine_state_dict``,
``optimizer_state_dict``; ``intrinsicnerf_tpu/tools/import_ckpt.py:3-7``),
so ``import_reference_ckpt.py`` brings a port run into the JAX package.
It adds ``generator_state``, the training draws' generator, so that a
resumed run draws what the uninterrupted run would have; a data-parallel
run adds ``generator_states``, every rank's in rank order (rank 0's is
also ``generator_state``).  A restore at the world size a file was
written at puts each rank's generator back; at another, it leaves the
freshly seeded generator and says so.

A packed training state (``models/mlp.py:PackedMLP``) is written in the
same layout: its models' ``state_dict`` is the reference one, and Adam's
moments are unpacked the same way into the per-parameter entries the
unpacked path's Adam keeps (their padded slots are zero, so nothing is
lost).  A restore into packed state packs them again, so a file loads
into either layout and a packed resume stays exact.

The optimizer's state dict carries Adam's moments and each parameter's
step count, so a restore resumes bias correction exactly; the learning
rate the step sets by hand is recomputed from ``global_step`` (the file
keeps it as a number, and Adam's step counts on the host, whether or
not the run's Adam was ``capturable``).  A restore puts the counts where
the restoring Adam keeps them and sets the device step counter.  A save
copies every tensor to the host first (that copy waits for the device)
and only then hands the write to a background thread, so training
cannot change what is written.  The newest ``MAX_TO_KEEP`` files stay.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from intrinsicnerf_tpu_torch.models.mlp import PackedMLP
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.train.step import TrainState

MAX_TO_KEEP = 5  # checkpoints kept per run, as the JAX package keeps


def _host(obj):
    """A deep copy of ``obj`` with every tensor copied to the host."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step:06d}.ckpt")


def saved_steps(ckpt_dir: str) -> list:
    """The steps of the complete checkpoints in ``ckpt_dir``, ascending."""
    names = (os.path.basename(p)[: -len(".ckpt")]
             for p in glob.glob(os.path.join(ckpt_dir, "*.ckpt")))
    return sorted(int(n) for n in names if n.isdigit())


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step in ``ckpt_dir``, or None."""
    steps = saved_steps(ckpt_dir)
    return steps[-1] if steps else None


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _models(state: TrainState) -> list:
    return [m for m in (state.model_coarse, state.model_fine) if m is not None]


def optimizer_state_dict(state: TrainState) -> dict:
    """Adam's state dict in the unpacked layout: one entry per reference
    parameter of each model in turn, a packed model's moments unpacked."""
    opt_sd = state.optimizer.state_dict()
    if not isinstance(state.model_coarse, PackedMLP):
        return opt_sd
    adam_of = state.optimizer.state
    out, i = {}, 0
    for m in _models(state):
        adam = adam_of.get(m.weight)
        moments = {n: m.unpack(fm.FlatBlocks(adam[n], adam_of[m.bias][n])) for n in _MOMENTS
                   } if adam else None
        for key in m.reference_keys:
            if moments is not None:
                out[i] = {"step": adam["step"].clone(), **{n: moments[n][key] for n in _MOMENTS}}
            i += 1
    (group,) = opt_sd["param_groups"]
    return {"state": out, "param_groups": [{**group, "params": list(range(i))}]}


def _packed_optimizer_state_dict(state: TrainState, opt_sd: dict) -> dict:
    """Inverse of :func:`optimizer_state_dict`: the unpacked layout's
    entries packed into each packed model's two buffers."""
    out, i, j = {}, 0, 0
    for m in _models(state):
        keys = m.reference_keys
        first = opt_sd["state"].get(i)
        if first is not None:
            flat = {n: m.pack({k: opt_sd["state"][i + q][n] for q, k in enumerate(keys)})
                    for n in _MOMENTS}
            for buf, name in ((j, "weight"), (j + 1, "bias")):
                out[buf] = {"step": first["step"].clone(),  # Adam counts each in place
                            **{n: getattr(flat[n], name) for n in _MOMENTS}}
        i, j = i + len(keys), j + 2
    (group,) = opt_sd["param_groups"]
    return {"state": out, "param_groups": [{**group, "params": list(range(j))}]}


def snapshot(state: TrainState, generator: Optional[torch.Generator] = None,
             generator_states: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """The checkpoint dict of ``state``, on the host; ``generator_states``
    are every rank's generator states of a data-parallel run."""
    ckpt = {
        "global_step": int(state.step),
        "network_coarse_state_dict": state.model_coarse.state_dict(),
        "network_fine_state_dict": (state.model_fine.state_dict()
                                    if state.model_fine is not None else None),
        "optimizer_state_dict": optimizer_state_dict(state),
    }
    if generator is not None:
        ckpt["generator_state"] = generator.get_state()
    if generator_states is not None:
        ckpt["generator_states"] = list(generator_states)
        ckpt["generator_state"] = generator_states[0]
    ckpt = _host(ckpt)
    for group in ckpt["optimizer_state_dict"]["param_groups"]:
        if torch.is_tensor(group["lr"]):  # the graphed step's device LR
            group["lr"] = float(group["lr"])
    return ckpt


def restore_into(state: TrainState, ckpt: dict, generator: Optional[torch.Generator] = None,
                 rank: int = 0, world: int = 1) -> int:
    """Load ``ckpt`` into ``state`` (and ``generator``, as rank ``rank``
    of ``world``) in place; returns the restored step."""
    state.model_coarse.load_state_dict(ckpt["network_coarse_state_dict"])
    if state.model_fine is not None:
        state.model_fine.load_state_dict(ckpt["network_fine_state_dict"])
    # Adam places its step counts by the loaded groups' ``capturable``:
    # keep this optimizer's, so a host run's file resumes on the card
    opt_sd = ckpt["optimizer_state_dict"]
    if isinstance(state.model_coarse, PackedMLP):
        opt_sd = _packed_optimizer_state_dict(state, opt_sd)
    groups = [{**saved, "capturable": own["capturable"]}
              for saved, own in zip(opt_sd["param_groups"], state.optimizer.param_groups)]
    state.optimizer.load_state_dict({**opt_sd, "param_groups": groups})
    state.step = int(ckpt["global_step"])
    state.step_t.fill_(state.step)
    gens = ckpt.get("generator_states",
                    [ckpt["generator_state"]] if "generator_state" in ckpt else [])
    if generator is not None and len(gens) == world:
        generator.set_state(gens[rank])
    elif generator is not None and gens:
        print(f"checkpoint of {len(gens)} rank(s) resumed at {world}: rank {rank}'s "
              "training draws start from a fresh seed")
    return state.step


def _write(ckpt: dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


class Checkpointer:
    """Checkpoints of one run in one directory, written off the loop."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(self, state: TrainState, step: int, generator: Optional[torch.Generator] = None,
             generator_states: Optional[Sequence[torch.Tensor]] = None) -> None:
        """Copy ``state`` to the host now; write it in the background."""
        ckpt = snapshot(state, generator, generator_states)
        ckpt["global_step"] = int(step)
        self.wait()  # one write at a time, in order
        self._pending = self._pool.submit(self._save_and_prune, ckpt, step)

    def _save_and_prune(self, ckpt: dict, step: int) -> None:
        _write(ckpt, checkpoint_path(self.ckpt_dir, step))
        steps = saved_steps(self.ckpt_dir)
        for old in steps[: max(0, len(steps) - MAX_TO_KEEP)]:
            os.remove(checkpoint_path(self.ckpt_dir, old))

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.ckpt_dir)

    def restore(self, state: TrainState, step: Optional[int] = None,
                generator: Optional[torch.Generator] = None, rank: int = 0,
                world: int = 1) -> Optional[int]:
        """Restore ``step`` (default: the newest) into ``state`` as rank
        ``rank`` of ``world``; None when the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        # on the host: load_state_dict moves the moments to each parameter's
        # device and keeps Adam's step counts on the host, as a fresh run has them
        ckpt = torch.load(checkpoint_path(self.ckpt_dir, step), map_location="cpu")
        return restore_into(state, ckpt, generator, rank, world)

    def wait(self) -> None:
        """Join the write in flight; its error, if any, is raised here."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
