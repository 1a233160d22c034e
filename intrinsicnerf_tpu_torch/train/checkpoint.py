"""Checkpoints in the original ``.ckpt`` layout, saved off the training loop.

Port of ``intrinsicnerf_tpu/train/checkpoint.py``, with ``torch.save`` in
place of Orbax.  Each save writes ``<ckpt_dir>/{step:06d}.ckpt``, a dict
with the original scene trainer's keys (``global_step``,
``network_coarse_state_dict``, ``network_fine_state_dict``,
``optimizer_state_dict``; ``intrinsicnerf_tpu/tools/import_ckpt.py:3-7``),
so ``import_reference_ckpt.py`` brings a port run into the JAX package.
It adds ``generator_state``, the training draws' generator, so that a
resumed run draws what the uninterrupted run would have.

The optimizer's state dict carries Adam's moments and each parameter's
step count, so a restore resumes bias correction exactly; the learning
rate the step sets by hand is recomputed from ``global_step``.  A save
copies every tensor to the host first (that copy waits for the device)
and only then hands the write to a background thread, so training
cannot change what is written.  The newest ``MAX_TO_KEEP`` files stay.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

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


def snapshot(state: TrainState, generator: Optional[torch.Generator] = None) -> dict:
    """The checkpoint dict of ``state``, on the host."""
    ckpt = {
        "global_step": int(state.step),
        "network_coarse_state_dict": state.model_coarse.state_dict(),
        "network_fine_state_dict": (state.model_fine.state_dict()
                                    if state.model_fine is not None else None),
        "optimizer_state_dict": state.optimizer.state_dict(),
    }
    if generator is not None:
        ckpt["generator_state"] = generator.get_state()
    return _host(ckpt)


def restore_into(state: TrainState, ckpt: dict,
                 generator: Optional[torch.Generator] = None) -> int:
    """Load ``ckpt`` into ``state`` (and ``generator``) in place; returns
    the restored step."""
    state.model_coarse.load_state_dict(ckpt["network_coarse_state_dict"])
    if state.model_fine is not None:
        state.model_fine.load_state_dict(ckpt["network_fine_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["global_step"])
    if generator is not None and "generator_state" in ckpt:
        generator.set_state(ckpt["generator_state"])
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

    def save(self, state: TrainState, step: int,
             generator: Optional[torch.Generator] = None) -> None:
        """Copy ``state`` to the host now; write it in the background."""
        ckpt = snapshot(state, generator)
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
                generator: Optional[torch.Generator] = None) -> Optional[int]:
        """Restore ``step`` (default: the newest) into ``state``; None when
        the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        # on the host: load_state_dict moves the moments to each parameter's
        # device and keeps Adam's step counts on the host, as a fresh run has them
        ckpt = torch.load(checkpoint_path(self.ckpt_dir, step), map_location="cpu")
        return restore_into(state, ckpt, generator)

    def wait(self) -> None:
        """Join the write in flight; its error, if any, is raised here."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
