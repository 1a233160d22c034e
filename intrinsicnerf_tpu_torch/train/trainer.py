"""The scene trainer: the training loop with its periodic work.

Port of ``intrinsicnerf_tpu/train/trainer.py:Trainer``:

- the step (``train/step.py:make_train_step``) every iteration, with the
  cluster term off (``w_c = 0``) until the first rebuild;
- every ``step_log_tfb`` steps the loss terms, the schedule weights and
  the raw-sigma histograms of a fixed 512-ray probe;
- every ``step_save_ckpt`` steps a checkpoint (``train/checkpoint.py``);
- every ``step_vis_train`` steps the cluster rebuild: render the train
  views, mean-shift the rendered albedo per semantic class, swap in the
  new anchor table and anneal ``(w_c, b_f)``; the train renders, the
  palette and the clustered / recomposed previews go to
  ``train_render/step_NNNNNN``;
- every ``step_val`` steps the evaluation of the test views (PSNR, the
  depth metrics, mIoU), rendered to ``test_render/step_NNNNNN``.

File names, the palette layout and the ``tfb_logs/scalars.csv`` rows are
the JAX package's, so its GUI, editing tools and gate read a port run.
``maybe_resume`` restores the newest checkpoint (parameters, Adam state,
the draws' generator) and the newest palette no newer than it.

``steps_per_call = K > 1`` runs K steps per call as one CUDA graph
replay (``train/step.py:make_multi_step``) when K divides the start step,
the steps left and every cadence (``_steps_per_call``, the JAX rule).
The graph reads the cluster table and ``w_c`` from tensors the trainer
keeps for its whole life and copies new values into (``_set_table``,
``_w_c_t``), so a rebuild or a restore reaches the next replay.

The object pipeline passes its pose sampler (``make_object_sample_fn``)
as ``sample_fn``; its bundle renders the test views at each rebuild
(``rays_cluster``) and has no semantic head.  After each rebuild and
evaluation the rendered frames become mp4s (``tools/video.py``).

``group`` (a ``parallel.mesh.DataGroup``, the twin of ``mesh=``) trains
data-parallel, one process per GPU: the pools are padded and sharded by
image (or, loaded host-locally, already are this rank's), the state is
broadcast from rank 0 at the start and after a resume, each rank draws
from its own generator, the step averages gradients and loss terms over
the group, and every full-image render is split over the ranks and
gathered (``parallel/sharded_render.py``), so every rank rebuilds the same
cluster table from the same views.  Files (logs, the config, renders,
palettes, videos, checkpoints) are written by rank 0 only; a checkpoint
keeps every rank's generator state.

``render_views`` is also a free function: the serving path.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.cluster.assign import (
    ClusterTable, dest_color_chunked, empty_cluster_table)
from intrinsicnerf_tpu_torch.cluster.manager import ClusterManager
from intrinsicnerf_tpu_torch.cluster.meanshift import backend as meanshift_backend
from intrinsicnerf_tpu_torch.core.losses import semantic_entropy
from intrinsicnerf_tpu_torch.core.metrics import (
    calculate_depth_metrics, calculate_segmentation_metrics, psnr_np)
from intrinsicnerf_tpu_torch.data.samplers import sample_ray_pairs_from_poses
from intrinsicnerf_tpu_torch.models.mlp import MLP, MLPConfig
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays, render_rays_chunked
from intrinsicnerf_tpu_torch.tools.video import generate_all
from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer
from intrinsicnerf_tpu_torch.parallel.distributed import make_global_pools
from intrinsicnerf_tpu_torch.parallel.mesh import (
    DataGroup, all_gather_rows, pad_images_to_multiple, replicate, shard_pools)
from intrinsicnerf_tpu_torch.parallel.sharded_render import make_sharded_render
from intrinsicnerf_tpu_torch.parallel.sharded_step import rank_generator
from intrinsicnerf_tpu_torch.train.logging_utils import NullLogger, ProfilerTrace, TBLogger
from intrinsicnerf_tpu_torch.train.schedules import cluster_anneal
from intrinsicnerf_tpu_torch.train.step import (
    DataPools, TrainState, create_train_state, make_multi_step, make_train_step, packs_state)
from intrinsicnerf_tpu_torch.utils.image import (
    depth2rgb, imwrite, label_colormap, plot_semantic_legend, to8b)


@dataclasses.dataclass
class SceneBundle:
    """One scene's training data, its tensors on the training device."""

    pools: DataPools  # full-resolution training pools
    rays_vis: torch.Tensor  # [num_train, Hs*Ws, 11] scaled train-view rays
    rays_test: torch.Tensor  # [num_test, Hs*Ws, 11]
    h: int
    w: int
    h_scaled: int
    w_scaled: int
    num_valid_classes: int  # semantic classes without void (0 when off)
    # the views a cluster rebuild renders; None: the train views (rays_vis)
    rays_cluster: Optional[torch.Tensor] = None
    test_gt: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    train_gt: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    colour_map: Optional[np.ndarray] = None  # [C+1, 3] with the void row
    class_names: Optional[list] = None  # ["void", ...] by original id
    semantic_class_ids: Optional[np.ndarray] = None  # original ids with void
    # the pools hold only this process's images (host-local loading), not all
    pools_local: bool = False


def make_object_sample_fn(cfg, bundle: SceneBundle, ndc_focal=None):
    """The pose-based pair sampler with the precrop warm-up, for the object
    pipeline (twin of the JAX ``make_object_sample_fn``); ``ndc_focal``
    turns on the LLFF forward-facing NDC projection.  The crop is decided
    on the device from the step counter the step hands it, so a CUDA
    graph replay ends the warm-up where the eager steps would."""
    near, far = cfg.depth_range
    h, w, n_rays = bundle.h, bundle.w, cfg.train.n_rays

    def sample_fn(generator, pools, step):
        return sample_ray_pairs_from_poses(
            generator, pools.dirs_cam, pools.poses, pools.rgb, h, w, n_rays, near, far,
            mask_pool=pools.mask, step=step, precrop_iters=cfg.precrop_iters,
            precrop_frac=cfg.precrop_frac, ndc_focal=ndc_focal)

    return sample_fn


def _host(x: torch.Tensor, *shape) -> np.ndarray:
    if x.is_floating_point():
        x = x.float()
    return x.cpu().numpy().reshape(*shape)


def render_views(
    model_c: MLP,
    model_f: Optional[MLP],
    mcfg: MLPConfig,
    rcfg: RenderConfig,
    rays_all,  # [N, H*W, 11] tensor or array
    h: int,
    w: int,
    chunk: int,
    device="cuda",
) -> Iterator[Dict[str, np.ndarray]]:
    """Render every view in ``rays_all``; yields per-view dicts of numpy
    maps: rgb, disp, depth, acc, albedo, shading, residual and, with
    semantics, ``sem_label`` (argmax) and ``sem_entropy``.  The next
    view is queued on the device before the current one is copied to the
    host, so device and host work overlap.  The models must lie on
    ``device``; a missing GPU raises here, at the call, not at the
    first view."""
    rays_all = torch.as_tensor(rays_all, dtype=torch.float32, device=resolve_device(device))
    return _views(lambda r: render_rays_chunked(model_c, model_f, mcfg, r, rcfg, chunk),
                  rays_all, h, w)


@torch.no_grad()
def _views(render_rays_of, rays_all, h, w):
    """``render_views``' loop over the views of ``rays_all``, each rendered
    by ``render_rays_of(rays [H*W, 11]) -> RenderResult``."""
    def render(i):
        return render_rays_of(rays_all[i])

    n = rays_all.shape[0]
    pending = render(0) if n else None
    for i in range(n):
        out = pending
        if i + 1 < n:
            pending = render(i + 1)
        maps = out.fine if out.fine is not None else out.coarse
        view = {
            "rgb": _host(maps.rgb, h, w, 3),
            "disp": _host(maps.disp, h, w),
            "depth": _host(maps.depth, h, w),
            "acc": _host(maps.acc, h, w),
            "albedo": _host(maps.albedo, h, w, 3),
            "shading": _host(maps.shading, h, w),
            "residual": _host(maps.residual, h, w, 3),
        }
        if maps.sem_logits is not None:
            view["sem_label"] = _host(torch.argmax(maps.sem_logits, dim=-1), h, w)
            view["sem_entropy"] = _host(semantic_entropy(maps.sem_logits), h, w)
        if maps.endpoint_feat is not None:
            view["feat"] = _host(maps.endpoint_feat, h, w, -1)
        # reference parity: NaN/Inf alarm on every rendered map
        for k, v in view.items():
            if not np.isfinite(v).all():
                print(f"! [Numerical Error] view {i} map '{k}' contains nan or inf.")
        yield view


class Trainer:
    """Trains one scene on one device (default ``"cuda"``, which raises
    without a GPU), or on this rank's device of ``group`` (without one,
    a group of one process whose collectives do nothing).
    ``step_hook(step, t_start, t_enqueued, did_work)``,
    when set, is called after each call of the step (one step, or a block
    of ``steps_per_call``) with the step count after it, the host clock
    before the call and after it was enqueued, and whether the call did
    periodic work (log, checkpoint, rebuild, eval); ``profile_steps = N``
    traces N steps with ``torch.profiler``.  ``sample_fn`` replaces the
    step's pool sampler (the object pipeline's pose sampler)."""

    def __init__(self, cfg, bundle: SceneBundle, seed: int = 0, device="cuda", sample_fn=None,
                 group=None):
        self._t_made = time.perf_counter()
        self.device = resolve_device(device)
        if group is None:  # one process: a group of one, whose collectives do nothing
            group = DataGroup(0, 1, None, self.device)
        elif group.device.type != self.device.type:
            raise ValueError(f"a {self.device.type} trainer got a group on {group.device}")
        self.device = group.device
        self.group = group
        self.lead = group.lead  # this process writes the files
        self.cfg = cfg
        self.save_dir = cfg.experiment.save_dir
        if self.lead:
            os.makedirs(self.save_dir, exist_ok=True)
        self.logger = (TBLogger(os.path.join(self.save_dir, "tfb_logs"), cfg.raw) if self.lead
                       else NullLogger())
        if cfg.raw and self.lead:  # the config, as the original trainer dumps it
            import yaml

            with open(os.path.join(self.save_dir, "exp_config.yaml"), "w") as f:
                yaml.safe_dump(cfg.raw, f, default_flow_style=False)

        self.mcfg: MLPConfig = dataclasses.replace(
            cfg.mlp, num_semantic_classes=bundle.num_valid_classes)
        if bundle.num_valid_classes == 0:
            self.mcfg = dataclasses.replace(self.mcfg, enable_semantic=False)
        print("MLP compute path: " + (
            "fused CUDA kernels (kernel 1 forward, kernel 2 backward; packed training state)"
            if packs_state(self.mcfg) else "plain PyTorch layers" + (
                " (use_fused_kernel set but architecture ineligible)"
                if self.mcfg.use_fused_kernel else "")))

        self.state: TrainState = create_train_state(
            self.mcfg, cfg.train, device=self.device,
            generator=torch.Generator().manual_seed(seed),
            with_fine=cfg.render.n_importance > 0)
        if bundle.pools_local:  # the CLI loaded only this rank's images
            pools = make_global_pools(group, bundle.pools)
        else:
            pools = shard_pools(group, pad_images_to_multiple(bundle.pools, group.world))
        bundle = dataclasses.replace(bundle, pools=pools)
        replicate(group, self.state)
        self.step_fn = make_train_step(self.mcfg, cfg.render, cfg.train, bundle.h, bundle.w,
                                       sample_fn=sample_fn, group=group)
        # every training draw (pixels, jitter, sigma noise, importance
        # uniforms) comes from this rank's generator; checkpoints keep its state
        self.generator = rank_generator(seed, group)
        n_view = bundle.h_scaled * bundle.w_scaled
        self._render = make_sharded_render(self.mcfg, cfg.render, group, n_view,
                                           chunk=min(cfg.chunk, n_view))
        self.bundle = bundle

        self.n_table_classes = max(1, 1 if cfg.train.no_semantic_tree else bundle.num_valid_classes)
        self.cluster_manager: Optional[ClusterManager] = None
        # the table the step reads: these tensors stay, new tables are copied in
        empty = empty_cluster_table(self.n_table_classes, device=self.device)
        self.table: ClusterTable = empty._replace(intensity_factor=torch.tensor(
            empty.intensity_factor, dtype=torch.float32, device=self.device))
        self.w_c = 0.01
        self._w_c_t = torch.zeros((), dtype=torch.float32, device=self.device)  # w_c as applied
        self.multi_step = None  # the block of steps_per_call steps, made by fit
        self.b_f = 0.25
        self.last_rebuild: Dict[str, object] = {}  # seconds and the mean-shift path
        # image writes run off the loop; flush_io() joins them
        self._io_pool = ThreadPoolExecutor(max_workers=8)
        self._io_futures = []
        self.global_step = 0
        self._ckpt: Optional[Checkpointer] = None
        self._profiler: Optional[ProfilerTrace] = None
        self.profile_steps = 0
        self.step_hook: Optional[Callable[[int, float, float, bool], None]] = None
        # raw-sigma probe: a fixed block of 512 rays of the first train view
        n_probe = min(512, bundle.rays_vis.shape[1]) if len(bundle.rays_vis) else 0
        self._probe_rays = bundle.rays_vis[0, :n_probe] if n_probe else None

    def _checkpointer(self) -> Checkpointer:
        if self._ckpt is None:
            self._ckpt = Checkpointer(os.path.join(self.save_dir, "checkpoints"))
        return self._ckpt

    def close(self):
        """Join the checkpoint write and the image writes, close the
        logger.  Idempotent."""
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None
        if self._profiler is not None:
            self._stop_profile()
        self.flush_io()
        self._io_pool.shutdown(wait=True)
        self.logger.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ resume

    def maybe_resume(self) -> int:
        """Restore the newest checkpoint under ``save_dir/checkpoints``, if
        any, and the palette that goes with it; returns the global step.
        Every rank reads the file and takes its own generator state from it
        (a file of another world size reseeds the draws), and the state is
        broadcast from rank 0 again; a rank that did not restore the step
        rank 0 did (a ``save_dir`` the ranks do not share) raises."""
        step, before = None, self.state.step
        if os.path.isdir(os.path.join(self.save_dir, "checkpoints")):
            step = self._checkpointer().restore(self.state, generator=self.generator,
                                                rank=self.group.rank, world=self.group.world)
        replicate(self.group, self.state)
        if self.state.step != (before if step is None else step):
            raise RuntimeError(
                f"rank {self.group.rank} restored step {step} from {self.save_dir}, rank 0 step "
                f"{self.state.step}: resuming needs a save_dir that every rank reads")
        if step is not None:
            self.global_step = step
            if self.lead:
                print(f"resumed from step {step}")
            self._restore_cluster_state()
        return self.global_step

    def _restore_cluster_state(self):
        """Reload the newest palette written no later than the restored
        step, so the cluster term stays on across a restart, and re-derive
        the anneal as the rebuild that wrote it did.  A palette a kill cut
        off (no ``clusters.json``, or one that does not read) gives way to
        the next older one; with none, the term resumes at the next
        rebuild."""
        if self.cfg.train.no_cluster:
            return
        found = []
        for d in glob.glob(os.path.join(self.save_dir, "train_render", "step_*", "cluster")):
            if not os.path.exists(os.path.join(d, "clusters.json")):
                continue  # a rebuild cut off while writing
            name = os.path.basename(os.path.dirname(d)).split("_")[-1]
            if name.isdigit() and int(name) <= self.global_step:
                found.append((int(name), d))
        for best_step, best_dir in sorted(found, reverse=True):
            try:
                mgr = ClusterManager.load(best_dir)
            except (OSError, ValueError, KeyError) as e:  # a truncated JSON
                print(f"cluster palette at {best_dir} unreadable ({e}); trying an older one")
                continue
            self.cluster_manager = mgr
            self._set_table(mgr.to_table(device=self.device))
            self.w_c, self.b_f = cluster_anneal(best_step, self.cfg.logging.step_vis_train,
                                                self.cfg.train.n_iters, self.cfg.b_f_cap)
            if self.lead:
                print(f"cluster palette restored from rebuild @{best_step} "
                      f"(w_c={self.w_c:.3g}, b_f={self.b_f:.3g})")
            return
        if found:
            print("no cluster palette readable; the cluster term resumes at the next rebuild")

    # ------------------------------------------------------------- train

    def _set_table(self, table: ClusterTable):
        """Copy ``table`` into the tensors the step reads."""
        for buf, new in zip(self.table[:4], table[:4]):
            buf.copy_(new)
        self.table.intensity_factor.fill_(float(table.intensity_factor))

    def _steps_per_call(self, n_iters: int, start: int) -> int:
        """Steps per call of the fit loop: the config's ``steps_per_call``
        when it divides the start step, the steps left and every cadence
        (a block must end on each log, checkpoint, rebuild and eval step),
        else 1 with a message; 1 while ``--profile`` traces steps."""
        k = max(1, int(self.cfg.train.steps_per_call))
        if k == 1:
            return 1
        log = self.cfg.logging
        cadences = (log.step_log_tfb, log.step_save_ckpt,
                    log.step_vis_train, log.step_val, n_iters - start)
        if self.profile_steps > 0:
            print("steps_per_call: disabled while --profile is active")
            return 1
        if start % k or any(c % k for c in cadences):
            print(
                f"steps_per_call={k} does not divide start={start} and the "
                f"logging cadences {cadences}; falling back to 1"
            )
            return 1
        return k

    def fit(self, n_iters: Optional[int] = None, progress: bool = True):
        """Train from ``global_step`` to ``n_iters`` (default: the
        config's); returns the last step's ``LossReport``."""
        n_iters = n_iters or self.cfg.train.n_iters
        log = self.cfg.logging
        start = self.global_step
        if start == 0:
            self.log_gt_panels()
        spc = self._steps_per_call(n_iters, start)
        self.logger.scalars(max(start, 1), {"Train/steps_per_call_effective": float(spc)})
        step_fn = self.step_fn
        if spc > 1:
            if self.multi_step is None or self.multi_step.k != spc:
                self.multi_step = make_multi_step(self.step_fn, spc)
            step_fn = self.multi_step
        it = range(start, n_iters, spc)
        if progress and self.lead:
            from tqdm import trange

            # tqdm counts blocks, so the resume's initial is in blocks too
            it = trange(start, n_iters, spc, initial=start // spc)
        # --profile N traces steps [start+1, start+1+N): the first step,
        # which builds the kernels, stays out of the trace
        prof_start = start + 1 if self.profile_steps > 0 and self.lead else None
        prof_stop = prof_start + self.profile_steps if prof_start is not None else None
        t0 = time.time()
        report = None
        for i in it:
            self.global_step = i
            if i == prof_start:
                self._profiler = ProfilerTrace(self.save_dir)
            if i == prof_stop and self._profiler is not None:
                self._stop_profile()
            t_start = time.perf_counter()
            # no cluster term until the first rebuild
            self._w_c_t.fill_(self.w_c if self.cluster_manager is not None else 0.0)
            report = step_fn(self.state, self.bundle.pools, self.table, self._w_c_t,
                             self.generator)
            t_enqueued = time.perf_counter()
            done = i + spc
            did_work = False
            if done % log.step_log_tfb == 0:
                self._log_scalars(done, report, time.time() - t0)
                t0 = time.time()
                did_work = True
            if done % log.step_save_ckpt == 0:
                self.save_checkpoint(done)
                did_work = True
            if done % log.step_vis_train == 0 and not self.cfg.train.no_cluster:
                self.rebuild_clusters(done)
                did_work = True
            if done % log.step_val == 0:
                self.evaluate(done)
                did_work = True
            self.global_step = done
            if self.step_hook is not None:
                self.step_hook(done, t_start, t_enqueued, did_work)
        if self._profiler is not None:  # --profile N past the end of the run
            self._stop_profile()
        self.flush_io()
        self._print_launches(self.global_step)
        return report

    def kernel_launches(self) -> Dict[str, int]:
        """Launches of kernel 1, its weight image and kernel 2 in this
        process so far: the wrappers' eager launches plus those of this
        trainer's graph replays (``make_multi_step``'s ``.replayed``)."""
        replayed = self.multi_step.replayed if self.multi_step is not None else {}
        return {name: c.launches + replayed.get(name, 0)
                for name, c in fm.LAUNCH_COUNTERS.items()}

    def _print_launches(self, step: int):
        """One ``kernel launches: {json}`` line (rank 0), with the seconds
        since the trainer was made: a run's log then says which kernels
        trained it and how fast, even when the process is killed."""
        if self.lead:
            line = {"step": step, "seconds": round(time.perf_counter() - self._t_made, 3),
                    **self.kernel_launches()}
            print("kernel launches: " + json.dumps(line), flush=True)

    def save_checkpoint(self, step: int):
        """Checkpoint the state at ``step`` (written off the loop): every
        rank's generator state is gathered, and rank 0 writes them all."""
        g = self.generator.get_state().to(self.device)[None]
        gens = all_gather_rows(self.group, g).cpu().unbind(0)
        if self.lead:
            self._checkpointer().save(self.state, step, self.generator, generator_states=gens)

    def _stop_profile(self):
        path = self._profiler.stop()
        self._profiler = None
        print(f"profiler trace written to {path}")

    def _log_scalars(self, step, report, dt):
        vals = {f"Train/Loss/{k}": float(v) for k, v in report._asdict().items()}
        vals["Train/steps_per_s"] = self.cfg.logging.step_log_tfb / max(dt, 1e-9)
        t = self.cfg.train
        vals["Train/w_residual"] = t.w_res1 if step <= t.residual_switch else t.w_res2
        vals["Train/w_intensity"] = t.w_i1 if step <= t.intensity_switch else t.w_i2
        vals["Train/w_c_eff"] = self.w_c if self.cluster_manager is not None else 0.0
        vals["Train/b_f"] = self.b_f
        self._print_launches(step)  # before the row a watcher of scalars.csv waits for
        self.logger.scalars(step, vals)
        if self._probe_rays is not None and self.logger.writer is not None:
            with torch.no_grad():
                out = render_rays(self.state.model_coarse, self.state.model_fine, self.mcfg,
                                  self._probe_rays, self.cfg.render, train=False)
            self.logger.histogram(step, "trans_coarse", _host(out.coarse.sigma, -1))
            if out.fine is not None:
                self.logger.histogram(step, "trans_fine", _host(out.fine.sigma, -1))

    # ------------------------------------------------------ image panels

    @staticmethod
    def _panel(frames, max_views: int = 4) -> np.ndarray:
        """Up to ``max_views`` HWC frames side by side, uint8."""
        frames = [f if f.dtype == np.uint8 else to8b(f) for f in frames[:max_views]]
        frames = [np.repeat(f[..., None], 3, axis=-1) if f.ndim == 2 else f for f in frames]
        return np.concatenate(frames, axis=1)

    def _cmap(self) -> np.ndarray:
        cmap = self.bundle.colour_map
        return cmap if cmap is not None else label_colormap(self.bundle.num_valid_classes + 1)

    def _vis_sem(self, label: np.ndarray) -> np.ndarray:
        out = self._cmap()[1:][np.clip(label, 0, None)].astype(np.uint8)
        out[label < 0] = 0  # void in black
        return out

    def log_gt_panels(self):
        """The semantic legend and the GT rgb / depth / label strips,
        logged once at the start of training."""
        near, far = self.cfg.depth_range
        legend = None
        if self.bundle.num_valid_classes > 0 and self.bundle.semantic_class_ids is not None:
            ids = np.asarray(self.bundle.semantic_class_ids)
            names = self.bundle.class_names or [f"class_{int(i)}" for i in range(int(ids.max()) + 1)]
            legend = plot_semantic_legend(ids, names, colormap=label_colormap(int(ids.max()) + 2),
                                          save_path=self.save_dir if self.lead else None)
        if self.logger.writer is None:
            return
        if legend is not None:
            self.logger.image(0, "Train/legend", legend)
            self.logger.image(0, "Test/legend", legend)
        for split, gt in (("Train", self.bundle.train_gt), ("Test", self.bundle.test_gt)):
            if "image" in gt:
                self.logger.image(0, f"{split}/rgb_GT", self._panel(gt["image"]))
            if "depth" in gt:
                self.logger.image(0, f"{split}/depth_GT",
                                  self._panel([depth2rgb(d, near, far) for d in gt["depth"]]))
            if "semantic" in gt:
                self.logger.image(0, f"{split}/vis_sem_label_GT",
                                  self._panel([self._vis_sem(s) for s in gt["semantic"]]))

    # ------------------------------------------------------- full renders

    def _save_async(self, path: str, arr: np.ndarray):
        """Queue an image write; it (and its error) lands at ``flush_io``."""
        self._io_futures.append(self._io_pool.submit(imwrite, path, arr))

    def flush_io(self):
        """Join the pending image writes."""
        for f in self._io_futures:
            f.result()
        self._io_futures.clear()

    def render_views(self, rays_all: torch.Tensor) -> Iterator[Dict[str, np.ndarray]]:
        """Render every view of ``rays_all [N, Hs*Ws, 11]`` with the current
        models, split over the group and gathered (``parallel/sharded_render.py``);
        yields per-view numpy maps at the scaled resolution."""
        rays_all = torch.as_tensor(rays_all, dtype=torch.float32, device=self.device)
        st = self.state
        return _views(lambda r: self._render(st.model_coarse, st.model_fine, r), rays_all,
                      self.bundle.h_scaled, self.bundle.w_scaled)

    def _save_view(self, save_dir: str, i: int, view: Dict[str, np.ndarray]):
        """Queue the files of one rendered view (rank 0 only)."""
        if not self.lead:
            return
        near, far = self.cfg.depth_range

        def p(name):
            return os.path.join(save_dir, f"{name}_{i:03d}.png")

        self._save_async(p("rgb"), to8b(view["rgb"]))
        self._save_async(p("albedo"), to8b(view["albedo"]))
        self._save_async(p("shading"), to8b(view["shading"]))
        self._save_async(p("residual"), to8b(view["residual"]))
        self._save_async(p("disp"), np.clip(np.nan_to_num(view["disp"]), 0, 65535).astype(np.uint16))
        self._save_async(p("depth"), (view["depth"] * 1000).astype(np.uint16))
        self._save_async(p("vis_depth"), depth2rgb(view["depth"], min_value=near, max_value=far))
        if "feat" in view:  # composited endpoint features, a float payload
            np.save(os.path.join(save_dir, f"feat_{i:03d}.npy"), view["feat"])
        if "sem_label" in view:
            self._save_async(p("label"), view["sem_label"].astype(np.uint8))
            self._save_async(p("vis_label"), self._cmap()[1:][view["sem_label"]].astype(np.uint8))
            self._save_async(p("entropy"), to8b(view["sem_entropy"]))
            self._save_async(p("vis_entropy"), depth2rgb(view["sem_entropy"]))

    # ----------------------------------------------------- cluster loop

    def rebuild_clusters(self, step: int, save: bool = True):
        """Render the rebuild views, rebuild the reflectance clusters with
        the annealed ``(w_c, b_f)``, swap in the new device table and write
        the renders, the palette and the previews.  ``last_rebuild`` keeps
        the seconds spent rendering and in mean-shift, and which
        mean-shift ran.  Under a group every rank renders (the split render
        is collective) and rebuilds the same table; rank 0 writes."""
        cfg = self.cfg
        save = save and self.lead
        self.w_c, self.b_f = cluster_anneal(step, cfg.logging.step_vis_train, cfg.train.n_iters,
                                            cfg.b_f_cap)
        save_dir = os.path.join(self.save_dir, "train_render", f"step_{step:06d}")
        if save:
            os.makedirs(save_dir, exist_ok=True)
        rays = self.bundle.rays_cluster if self.bundle.rays_cluster is not None else self.bundle.rays_vis
        tic = time.perf_counter()
        pixels, labels, views = [], [], []
        for i, view in enumerate(self.render_views(rays)):
            if save:
                self._save_view(save_dir, i, view)
            albedo_sub = view["albedo"][::2, ::2, :]
            if "sem_label" in view and not cfg.train.no_semantic_tree:
                lab_sub = view["sem_label"][::2, ::2]
            else:
                lab_sub = np.zeros(albedo_sub.shape[:2], np.int64)
            pixels.append(albedo_sub.reshape(-1, 3))
            labels.append(lab_sub.reshape(-1))
            views.append(view)
        render_s = time.perf_counter() - tic

        mgr = ClusterManager(class_num=self.n_table_classes)
        tic = time.perf_counter()
        mgr.update_centers(np.concatenate(labels), np.concatenate(pixels), band_factor=self.b_f)
        meanshift_s = time.perf_counter() - tic
        path = meanshift_backend()
        self.last_rebuild = {"render_s": render_s, "meanshift_s": meanshift_s, "meanshift": path,
                             "views": len(views)}
        if self.lead:
            print(f"cluster rebuild @{step}: render {render_s:.1f}s ({len(views)} views), "
                  f"mean-shift {meanshift_s:.1f}s ({path}) (w_c={self.w_c:.3g}, "
                  f"b_f={self.b_f:.3g})")
        self.cluster_manager = mgr
        self._set_table(mgr.to_table(device=self.device))
        if save:
            mgr.save(os.path.join(save_dir, "cluster"))
            self._save_cluster_previews(save_dir, views)
        if self.bundle.rays_cluster is None:  # the views are the train views
            self._log_train_render_metrics(step, views)
        else:
            self._log_view_panels(step, "Train", views)
        self.flush_io()
        if save:
            self._write_videos(save_dir)

    def _write_videos(self, save_dir: str):
        """mp4s of the rendered frames in ``save_dir``; a failed write is
        reported and training goes on."""
        try:
            generate_all(save_dir)
        except Exception as e:  # file IO only: no launch runs in here
            print(f"video write skipped: {e}")

    def _log_train_render_metrics(self, step: int, views):
        """Batch PSNR / MSE, the depth suite, the mIoU suite and panels of
        the train renders, at the rebuild cadence."""
        gt = self.bundle.train_gt
        if not views:
            return
        scalars: Dict[str, float] = {}
        if "image" in gt and len(gt["image"]) >= len(views):
            mse = float(np.mean([np.mean((v["rgb"] - gt["image"][i]) ** 2)
                                 for i, v in enumerate(views)]))
            scalars["Train/Metric/batch_MSE"] = mse
            scalars["Train/Metric/batch_PSNR"] = -10.0 * np.log10(max(mse, 1e-12))
        if "depth" in gt and len(gt["depth"]) >= len(views):
            dm = calculate_depth_metrics(np.stack([gt["depth"][i] for i in range(len(views))]),
                                         np.stack([v["depth"] for v in views]))
            scalars.update({f"Train/Metric/{k}": v for k, v in dm.items()})
        if "semantic" in gt and len(gt["semantic"]) >= len(views) and "sem_label" in views[0]:
            miou, miou_valid, acc, cls_acc, _ = calculate_segmentation_metrics(
                np.stack([gt["semantic"][i] for i in range(len(views))]),
                np.stack([v["sem_label"] for v in views]),
                self.bundle.num_valid_classes, ignore_label=-1)
            scalars.update({"Train/Metric/mIoU": miou, "Train/Metric/mIoU_validclass": miou_valid,
                            "Train/Metric/total_acc": acc, "Train/Metric/avg_acc": cls_acc})
        if scalars:
            self.logger.scalars(step, scalars)
        self._log_view_panels(step, "Train", views)

    def _log_view_panels(self, step: int, split: str, views):
        if self.logger.writer is None or not views:
            return
        near, far = self.cfg.depth_range
        self.logger.image(step, f"{split}/rgb", self._panel([v["rgb"] for v in views]))
        self.logger.image(step, f"{split}/depth",
                          self._panel([depth2rgb(v["depth"], near, far) for v in views]))
        disp_max = max(float(np.max(v["disp"])) for v in views) or 1.0
        self.logger.image(step, f"{split}/disps", self._panel([v["disp"] / disp_max for v in views]))
        if "sem_label" in views[0]:
            self.logger.image(step, f"{split}/vis_sem_label",
                              self._panel([self._vis_sem(v["sem_label"]) for v in views]))
            self.logger.image(step, f"{split}/vis_sem_uncertainty",
                              self._panel([depth2rgb(v["sem_entropy"]) for v in views]))

    def _save_cluster_previews(self, save_dir: str, views):
        """``c%03d.png`` (clustered albedo) and ``edit%03d.png`` (recomposed)."""
        for i, view in enumerate(views):
            hs, ws = view["albedo"].shape[:2]
            albedo = torch.from_numpy(view["albedo"].reshape(-1, 3)).to(self.device)
            if "sem_label" in view and not self.cfg.train.no_semantic_tree:
                label = torch.from_numpy(view["sem_label"].reshape(-1)).to(self.device)
            else:
                label = torch.zeros(hs * ws, dtype=torch.int64, device=self.device)
            with torch.no_grad():
                clustered = _host(dest_color_chunked(self.table, albedo, label), hs, ws, 3)
            self._save_async(os.path.join(save_dir, f"c{i:03d}.png"), to8b(clustered))
            edit = (clustered.reshape(-1, 3) * view["shading"].reshape(-1, 1)
                    + view["residual"].reshape(-1, 3)).reshape(hs, ws, 3)
            self._save_async(os.path.join(save_dir, f"edit{i:03d}.png"), to8b(edit))

    # ------------------------------------------------------------- eval

    def evaluate(self, step: int, save: bool = True) -> Dict[str, float]:
        """Render the test views; PSNR, the depth suite and the mIoU suite
        (where the ground truth is: rank 0 under host-local loading)."""
        save = save and self.lead
        tic = time.perf_counter()
        save_dir = os.path.join(self.save_dir, "test_render", f"step_{step:06d}")
        if save:
            os.makedirs(save_dir, exist_ok=True)
        gt = self.bundle.test_gt
        psnrs, depth_preds, sem_preds, views = [], [], [], []
        for i, view in enumerate(self.render_views(self.bundle.rays_test)):
            if save:
                self._save_view(save_dir, i, view)
            if "image" in gt:
                psnrs.append(psnr_np(view["rgb"], gt["image"][i]))
            depth_preds.append(view["depth"])
            if "sem_label" in view:
                sem_preds.append(view["sem_label"])
            views.append(view)
        metrics: Dict[str, float] = {}
        if psnrs:
            metrics["psnr"] = float(np.mean(psnrs))
        if "depth" in gt and depth_preds:
            metrics.update(calculate_depth_metrics(
                np.stack([gt["depth"][i] for i in range(len(depth_preds))]), np.stack(depth_preds)))
        if "semantic" in gt and sem_preds:
            miou, miou_valid, acc, cls_acc, _ = calculate_segmentation_metrics(
                np.stack([gt["semantic"][i] for i in range(len(sem_preds))]), np.stack(sem_preds),
                self.bundle.num_valid_classes, ignore_label=-1)
            metrics.update({"miou": miou, "miou_valid_class": miou_valid, "total_acc": acc,
                            "class_avg_acc": cls_acc})
        self.logger.scalars(step, {f"Test/{k}": v for k, v in metrics.items()})
        self._log_view_panels(step, "Test", views)
        if self.lead:
            print(f"eval @{step}: " + ", ".join(f"{k}={v:.4g}" for k, v in metrics.items())
                  + f" ({time.perf_counter() - tic:.1f} s)")
        if save:
            self.flush_io()  # the videos read the PNGs from disk
            self._write_videos(save_dir)
        return metrics
