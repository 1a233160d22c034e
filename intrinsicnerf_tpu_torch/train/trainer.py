"""The scene trainer: the training loop with its periodic work.

Port of ``intrinsicnerf_tpu/train/trainer.py:Trainer`` on one device:

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

Left out here: the device mesh and several hosts, the object pipeline's
pose sampler, ``steps_per_call > 1`` (one step per Python iteration; a
fused block of steps needs CUDA graphs) and the mp4s of
``tools/video.py``.  ``render_views`` is also a free function: the
serving path.
"""

from __future__ import annotations

import dataclasses
import glob
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
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays, render_rays_chunked
from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer
from intrinsicnerf_tpu_torch.train.logging_utils import ProfilerTrace, TBLogger
from intrinsicnerf_tpu_torch.train.schedules import cluster_anneal
from intrinsicnerf_tpu_torch.train.step import (
    DataPools, TrainState, create_train_state, make_train_step)
from intrinsicnerf_tpu_torch.utils.image import (
    depth2rgb, imwrite, label_colormap, plot_semantic_legend, to8b)

VIDEO_NOTE = "video write skipped: tools/video.py is not ported yet (ROADMAP queue 1, item 8)"


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


def _host(x: torch.Tensor, *shape) -> np.ndarray:
    if x.is_floating_point():
        x = x.float()
    return x.cpu().numpy().reshape(*shape)


def render_views(
    model_c: IntrinsicMLP,
    model_f: Optional[IntrinsicMLP],
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
    return _views(model_c, model_f, mcfg, rcfg, rays_all, h, w, chunk)


@torch.no_grad()
def _views(model_c, model_f, mcfg, rcfg, rays_all, h, w, chunk):
    def render(i):
        return render_rays_chunked(model_c, model_f, mcfg, rays_all[i], rcfg, chunk)

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
    without a GPU).  ``step_hook(step, t_start, t_enqueued, did_work)``,
    when set, is called after each step with the host clock before the
    step and after it was enqueued, and whether the step did periodic
    work (log, checkpoint, rebuild, eval); ``profile_steps = N`` traces N
    steps with ``torch.profiler``."""

    def __init__(self, cfg, bundle: SceneBundle, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.bundle = bundle
        self.save_dir = cfg.experiment.save_dir
        os.makedirs(self.save_dir, exist_ok=True)
        self.logger = TBLogger(os.path.join(self.save_dir, "tfb_logs"), cfg.raw)
        if cfg.raw:  # the config, as the original trainer dumps it
            import yaml

            with open(os.path.join(self.save_dir, "exp_config.yaml"), "w") as f:
                yaml.safe_dump(cfg.raw, f, default_flow_style=False)

        self.mcfg: MLPConfig = dataclasses.replace(
            cfg.mlp, num_semantic_classes=bundle.num_valid_classes)
        if bundle.num_valid_classes == 0:
            self.mcfg = dataclasses.replace(self.mcfg, enable_semantic=False)
        fused = self.mcfg.use_fused_kernel and (self.mcfg.depth, self.mcfg.width) == (8, 256)
        print("MLP compute path: " + ("fused CUDA kernels (kernel 1 forward, kernel 2 backward)"
                                      if fused else "plain PyTorch layers"))

        self.state: TrainState = create_train_state(
            self.mcfg, cfg.train, device=self.device,
            generator=torch.Generator().manual_seed(seed),
            with_fine=cfg.render.n_importance > 0)
        self.step_fn = make_train_step(self.mcfg, cfg.render, cfg.train, bundle.h, bundle.w)
        # every training draw (pixels, jitter, sigma noise, importance
        # uniforms) comes from this generator; checkpoints keep its state
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        self.n_table_classes = max(1, 1 if cfg.train.no_semantic_tree else bundle.num_valid_classes)
        self.cluster_manager: Optional[ClusterManager] = None
        self.table: ClusterTable = empty_cluster_table(self.n_table_classes, device=self.device)
        self.w_c = 0.01
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

    def _eval_chunk(self) -> int:
        return min(self.cfg.chunk, self.bundle.h_scaled * self.bundle.w_scaled)

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
        any, and the palette that goes with it; returns the global step."""
        if not os.path.isdir(os.path.join(self.save_dir, "checkpoints")):
            return self.global_step
        step = self._checkpointer().restore(self.state, generator=self.generator)
        if step is not None:
            self.global_step = step
            print(f"resumed from step {step}")
            self._restore_cluster_state()
        return self.global_step

    def _restore_cluster_state(self):
        """Reload the newest palette written no later than the restored
        step, so the cluster term stays on across a restart, and re-derive
        the anneal as the rebuild that wrote it did."""
        if self.cfg.train.no_cluster:
            return
        best_step, best_dir = -1, None
        for d in glob.glob(os.path.join(self.save_dir, "train_render", "step_*", "cluster")):
            if not os.path.exists(os.path.join(d, "clusters.json")):
                continue  # a rebuild cut off while writing
            name = os.path.basename(os.path.dirname(d)).split("_")[-1]
            if name.isdigit() and best_step < int(name) <= self.global_step:
                best_step, best_dir = int(name), d
        if best_dir is None:
            return
        try:
            mgr = ClusterManager.load(best_dir)
        except (OSError, ValueError, KeyError) as e:  # a truncated JSON
            print(f"cluster palette at {best_dir} unreadable ({e}); "
                  f"the cluster term resumes at the next rebuild")
            return
        self.cluster_manager = mgr
        self.table = mgr.to_table(device=self.device)
        self.w_c, self.b_f = cluster_anneal(best_step, self.cfg.logging.step_vis_train,
                                            self.cfg.train.n_iters, self.cfg.b_f_cap)
        print(f"cluster palette restored from rebuild @{best_step} "
              f"(w_c={self.w_c:.3g}, b_f={self.b_f:.3g})")

    # ------------------------------------------------------------- train

    def _steps_per_call(self) -> int:
        """Always 1: a block of several steps per call needs CUDA graphs,
        which the port does not have yet.  Says so when asked for more."""
        k = int(self.cfg.train.steps_per_call)
        if k > 1:
            print(f"steps_per_call={k}: the port runs one step per call (a fused block of "
                  f"steps needs CUDA graphs); using 1")
        return 1

    def fit(self, n_iters: Optional[int] = None, progress: bool = True):
        """Train from ``global_step`` to ``n_iters`` (default: the
        config's); returns the last step's ``LossReport``."""
        n_iters = n_iters or self.cfg.train.n_iters
        log = self.cfg.logging
        start = self.global_step
        if start == 0:
            self.log_gt_panels()
        spc = self._steps_per_call()
        self.logger.scalars(max(start, 1), {"Train/steps_per_call_effective": float(spc)})
        it = range(start, n_iters)
        if progress:
            from tqdm import trange

            it = trange(start, n_iters, initial=start)
        # --profile N traces steps [start+1, start+1+N): the first step,
        # which builds the kernels, stays out of the trace
        prof_start = start + 1 if self.profile_steps > 0 else None
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
            w_c_eff = self.w_c if self.cluster_manager is not None else 0.0
            report = self.step_fn(self.state, self.bundle.pools, self.table, w_c_eff,
                                  self.generator)
            t_enqueued = time.perf_counter()
            done = i + 1
            did_work = False
            if done % log.step_log_tfb == 0:
                self._log_scalars(done, report, time.time() - t0)
                t0 = time.time()
                did_work = True
            if done % log.step_save_ckpt == 0:
                self._checkpointer().save(self.state, done, self.generator)
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
        return report

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
                                          save_path=self.save_dir)
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
        models; yields per-view numpy maps at the scaled resolution."""
        return render_views(self.state.model_coarse, self.state.model_fine, self.mcfg,
                            self.cfg.render, rays_all, self.bundle.h_scaled,
                            self.bundle.w_scaled, self._eval_chunk(), device=self.device)

    def _save_view(self, save_dir: str, i: int, view: Dict[str, np.ndarray]):
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
        mean-shift ran."""
        cfg = self.cfg
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
        print(f"cluster rebuild @{step}: render {render_s:.1f}s ({len(views)} views), "
              f"mean-shift {meanshift_s:.1f}s ({path}) (w_c={self.w_c:.3g}, b_f={self.b_f:.3g})")
        self.cluster_manager = mgr
        self.table = mgr.to_table(device=self.device)
        if save:
            mgr.save(os.path.join(save_dir, "cluster"))
            self._save_cluster_previews(save_dir, views)
        if self.bundle.rays_cluster is None:  # the views are the train views
            self._log_train_render_metrics(step, views)
        else:
            self._log_view_panels(step, "Train", views)
        self.flush_io()
        if save:
            print(VIDEO_NOTE)

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
        """Render the test views; PSNR, the depth suite and the mIoU suite."""
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
        print(f"eval @{step}: " + ", ".join(f"{k}={v:.4g}" for k, v in metrics.items()))
        if save:
            self.flush_io()
            print(VIDEO_NOTE)
        return metrics
