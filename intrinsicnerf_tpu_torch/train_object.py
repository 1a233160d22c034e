"""Object-level training entry (Blender, Blender-intrinsic, LLFF,
DeepVoxels, LINEMOD), on the GPU.

The port's twin of ``train_object.py``, with its flags: a txt config with
CLI overrides; Blender's white-background composite with the alpha
channel as the intrinsic-loss object mask; the precrop warm-up; training
with periodic test renders and single-class cluster rebuilds; and the
``--render_only`` / ``--render_test`` modes.  An existing
``<save_dir>/checkpoints`` is resumed; ``steps_per_call`` in the txt runs
blocks of steps as one CUDA graph replay.

    python -m intrinsicnerf_tpu_torch.train_object --config configs/object/lego.txt
    python -m intrinsicnerf_tpu_torch.train_object --config cfg.txt --render_only --render_test
    python -m intrinsicnerf_tpu_torch.train_object --config cfg.txt --device cpu
    torchrun --nproc_per_node 4 -m intrinsicnerf_tpu_torch.train_object --config cfg.txt \
        --data_parallel

``--data_parallel`` (or any of ``--coordinator``, ``--num_processes``,
``--process_id``, as in the scene CLI) trains on one process per GPU: every
process loads the object, and the trainer keeps its shard of the pose
sampler's per-image pools (``dirs_cam`` is shared by all), so each rank
draws ``N_rand`` pairs of its own images.
"""

from __future__ import annotations

import argparse
import os

WEIGHT_FLAGS = ("w_r", "w_f", "w_s", "w_res1", "w_res2", "w_i1", "w_i2")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--expname", type=str, default=None)
    parser.add_argument("--render_only", action="store_true")
    parser.add_argument("--render_test", action="store_true")
    parser.add_argument("--n_iters", type=int, default=None)
    parser.add_argument("--no_progress", action="store_true")
    # loss-weight overrides (run.sh style: --w_s 10.0 --w_f 0.01)
    for k in WEIGHT_FLAGS + ("w_c",):
        parser.add_argument(f"--{k}", type=float, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="training device; 'cpu' runs the kernels' plain versions")
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd anomaly detection (slow)")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="trace N training steps with torch.profiler "
                        "(<save_dir>/profile/trace.json)")
    parser.add_argument("--seed", type=int, default=0, help="init / training draws seed")
    parser.add_argument("--data_parallel", action="store_true",
                        help="train on one process per GPU (the process flags imply it)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="tcp://HOST:PORT of rank 0's rendezvous (else torchrun's environment)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def load_object_data(cfg):
    """The dataset of ``cfg.experiment.dataset_type`` as ``BlenderData``;
    LLFF sets ``cfg.depth_range`` from its bounds (or [0, 1] in NDC)."""
    from intrinsicnerf_tpu_torch.data import blender

    dstype, ddir = cfg.experiment.dataset_type, cfg.experiment.dataset_dir
    if dstype == "blender":
        return blender.load_blender_data(ddir, half_res=cfg.half_res, testskip=cfg.testskip)
    if dstype == "blender_intrinsic":
        return blender.load_blender_intrinsic_data(ddir, half_res=cfg.half_res,
                                                   testskip=cfg.testskip)
    if dstype == "llff":
        return llff_as_blender(cfg)
    if dstype == "LINEMOD":
        from intrinsicnerf_tpu_torch.data.deepvoxels import load_linemod_data

        return load_linemod_data(ddir, half_res=cfg.half_res, testskip=cfg.testskip)
    if dstype == "deepvoxels":
        return deepvoxels_as_blender(cfg)
    raise ValueError(f"unknown object dataset_type: {dstype}")


def ndc_focal_for(cfg, data):
    """LLFF forward-facing scenes march in NDC unless ``no_ndc`` or
    ``spherify`` is set."""
    if (cfg.experiment.dataset_type == "llff" and not cfg.raw.get("no_ndc", False)
            and not cfg.raw.get("spherify", False)):
        return data.focal
    return None


def build_trainer(args):
    """The configuration, bundle and ``Trainer`` (not yet entered) of the
    parsed CLI ``args``."""
    from intrinsicnerf_tpu_torch.config import from_object_txt
    from intrinsicnerf_tpu_torch.parallel.distributed import join_group
    from intrinsicnerf_tpu_torch.train.prepare import prepare_blender_bundle
    from intrinsicnerf_tpu_torch.train.trainer import Trainer, make_object_sample_fn

    overrides = {k: getattr(args, k) for k in WEIGHT_FLAGS if getattr(args, k) is not None}
    if args.expname:
        overrides["expname"] = args.expname
    cfg = from_object_txt(args.config, overrides)
    group = join_group(args)
    data = load_object_data(cfg)
    ndc_focal = ndc_focal_for(cfg, data)
    bundle, _ = prepare_blender_bundle(cfg, data, ndc_focal=ndc_focal,
                                       device=group.device if group else args.device)
    sample_fn = make_object_sample_fn(cfg, bundle, ndc_focal=ndc_focal)
    trainer = Trainer(cfg, bundle, seed=args.seed, device=args.device, sample_fn=sample_fn,
                      group=group)
    trainer.profile_steps = args.profile
    return cfg, bundle, trainer


def main(argv=None):
    args = parse_args(argv)
    import torch

    from intrinsicnerf_tpu_torch.parallel.distributed import process_group_scope

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.w_c is not None:
        # the cluster-loss weight follows the annealed schedule; the flag is
        # accepted for CLI compatibility and, as in the original, not applied
        print("WARNING: --w_c is accepted for reference-CLI compatibility "
              "but ignored — the cluster-loss weight follows the annealed "
              "schedule, matching the reference (run_nerf.py:957,1063)")

    with process_group_scope():
        cfg, bundle, trainer = build_trainer(args)
        with trainer:
            trainer.maybe_resume()
            if args.render_only:
                save_dir = os.path.join(
                    cfg.experiment.save_dir,
                    f"renderonly_{'test' if args.render_test else 'path'}_"
                    f"{trainer.global_step:06d}")
                if trainer.lead:
                    os.makedirs(save_dir, exist_ok=True)
                rays = bundle.rays_test if args.render_test else bundle.rays_vis
                for i, view in enumerate(trainer.render_views(rays)):
                    trainer._save_view(save_dir, i, view)  # rank 0 writes
                trainer.flush_io()
                print(f"renders written to {save_dir}")
                return
            trainer.fit(n_iters=args.n_iters, progress=not args.no_progress)
    print("training complete")


def llff_as_blender(cfg):
    """LLFF data in the ``BlenderData`` form ``prepare_blender_bundle`` takes (the
    every-``llffhold``-th view held out, default 8)."""
    import numpy as np

    from intrinsicnerf_tpu_torch.data.blender import BlenderData
    from intrinsicnerf_tpu_torch.data.llff import load_llff_data

    raw = cfg.raw
    llff = load_llff_data(cfg.experiment.dataset_dir, factor=int(raw.get("factor", 8)),
                          spherify=bool(raw.get("spherify", False)))
    # depth bounds: NDC -> [0, 1]; otherwise from the scene's bounds
    if raw.get("no_ndc", False) or raw.get("spherify", False):
        cfg.depth_range = (float(llff.bds.min()) * 0.9, float(llff.bds.max()))
    else:
        cfg.depth_range = (0.0, 1.0)
    n = llff.images.shape[0]
    hold = int(raw.get("llffhold", 8))
    i_test = np.arange(n)[::hold] if hold > 0 else np.array([llff.i_test])
    i_train = np.array([i for i in range(n) if i not in i_test])

    def to44(p):  # [3,5] -> [4,4]
        out = np.tile(np.eye(4, dtype=np.float32), (p.shape[0], 1, 1))
        out[:, :3, :4] = p[:, :3, :4]
        return out

    rgba = np.concatenate([llff.images, np.ones_like(llff.images[..., :1])], axis=-1)
    return BlenderData(images=rgba, poses=to44(llff.poses), render_poses=to44(llff.render_poses),
                       h=llff.h, w=llff.w, focal=llff.focal, i_split=[i_train, i_test, i_test])


def deepvoxels_as_blender(cfg):
    import numpy as np

    from intrinsicnerf_tpu_torch.data.blender import BlenderData
    from intrinsicnerf_tpu_torch.data.deepvoxels import load_dv_data

    dv = load_dv_data(scene=str(cfg.raw.get("shape", "cube")),
                      basedir=cfg.experiment.dataset_dir, testskip=cfg.testskip)
    rgba = np.concatenate([dv.images, np.ones_like(dv.images[..., :1])], -1)
    return BlenderData(images=rgba, poses=dv.poses, render_poses=dv.render_poses, h=dv.h,
                       w=dv.w, focal=dv.focal, i_split=dv.i_split)


if __name__ == "__main__":
    main()
