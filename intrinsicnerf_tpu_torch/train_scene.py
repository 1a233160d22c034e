"""Scene-level training entry (Replica, ScanNet, Replica-NYU-CNN), on the GPU.

The port's twin of ``train_scene.py``, with the same flags and defaults:
a YAML config in the original schema; the dataset of its
``dataset_type`` (Replica and Replica-NYU split every 5th frame, ScanNet
every 5th with the test frames offset); the five label-degradation
experiments, applied in the JAX order; ``render.no_batching: false``
draws each ray's image on its own; then the training loop with its
periodic eval, cluster rebuild and checkpoint work.  An existing
``<save_dir>/checkpoints`` is resumed.

    python -m intrinsicnerf_tpu_torch.train_scene --config_file configs/scene/replica_room_0.yaml
    python -m intrinsicnerf_tpu_torch.train_scene --config_file cfg.yaml --sparse_views \\
        --sparse_ratio 0.5
    python -m intrinsicnerf_tpu_torch.train_scene --config_file cfg.yaml --device cpu

The multi-device flags (ROADMAP queue 1, item 7) are not ported yet and
raise.
"""

from __future__ import annotations

import argparse

DEGRADATION_FLAGS = ("sparse_views", "pixel_denoising", "region_denoising", "super_resolution",
                     "label_propagation")


def build_dataset(cfg, args):
    """The loaded dataset of ``cfg.experiment.dataset_type``, degraded as
    ``args``' flags ask (``args`` needs ``total_frames``, ``split_step``
    and the five degradation flags with their options)."""
    from intrinsicnerf_tpu_torch.data import degradations
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split, load_replica

    exp = cfg.experiment
    dstype = exp.dataset_type
    if dstype == "replica":
        train_ids, test_ids = default_replica_split(args.total_frames, args.split_step)
        data = load_replica(exp.dataset_dir, train_ids, test_ids, img_h=exp.height,
                            img_w=exp.width)
    elif dstype == "scannet":
        from intrinsicnerf_tpu_torch.data.scannet import load_scannet

        data = load_scannet(exp.dataset_dir, exp.scene_name,
                            mode=exp.nyu_mode if exp.nyu_mode != "nyu34" else "nyu40",
                            img_h=exp.height, img_w=exp.width)
    elif dstype == "replica_nyu_cnn":
        from intrinsicnerf_tpu_torch.data.replica_nyu import load_replica_nyu_cnn

        train_ids, test_ids = default_replica_split(args.total_frames, args.split_step)
        data = load_replica_nyu_cnn(exp.dataset_dir, train_ids, test_ids, nyu_mode=exp.nyu_mode,
                                    img_h=exp.height, img_w=exp.width)
    else:
        raise ValueError(f"unknown scene dataset_type: {dstype}")

    if args.sparse_views:
        degradations.sample_label_maps(data, sparse_ratio=args.sparse_ratio,
                                       random_sample=args.random_sample)
    if args.pixel_denoising:
        degradations.add_pixel_wise_noise_label(data, noise_ratio=args.pixel_noise_ratio)
    if args.region_denoising:
        inst = data.train_samples.get("instance")
        if inst is None:
            raise SystemExit("--region_denoising requires the dataset's semantic_instance maps")
        degradations.add_instance_wise_noise_label(data, inst, flip_ratio=args.region_noise_ratio)
    if args.super_resolution:
        degradations.super_resolve_label(data, down_scale_factor=args.dense_sr)
    if args.label_propagation:
        degradations.simulate_user_click_partial(data, perc=args.partial_perc)
    return data


def prepare_bundle(cfg, data, device):
    """The scene bundle of ``data`` on ``device``: ScanNet's preparer for
    ScanNet, Replica's for the rest."""
    from intrinsicnerf_tpu_torch.train.prepare import prepare_replica_bundle, prepare_scannet_bundle

    if cfg.experiment.dataset_type == "scannet":
        return prepare_scannet_bundle(cfg, data, device=device)
    return prepare_replica_bundle(cfg, data, device=device)


def all_images_sample_fn(cfg, bundle):
    """The step's sampler for ``render.no_batching: false``: each ray from
    an image drawn over the whole training set."""
    from intrinsicnerf_tpu_torch.data.samplers import sample_ray_pairs_all_images

    h, w, n_rays = bundle.h, bundle.w, cfg.train.n_rays

    def sample_fn(generator, pools, step):
        return sample_ray_pairs_all_images(generator, pools.rays, pools.rgb, h, w, n_rays,
                                           depth_pool=pools.depth, sem_pool=pools.semantic,
                                           mask_ids=pools.mask_ids)

    return sample_fn


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--gpu", type=str, default="")  # accepted for parity
    parser.add_argument("--device", type=str, default="cuda",
                        help="training device; 'cpu' runs the kernels' plain versions")
    parser.add_argument("--n_iters", type=int, default=None)
    parser.add_argument("--total_frames", type=int, default=900)
    parser.add_argument("--split_step", type=int, default=5)
    parser.add_argument("--sparse_views", action="store_true")
    parser.add_argument("--sparse_ratio", type=float, default=0.0)
    parser.add_argument("--random_sample", action="store_true")
    parser.add_argument("--pixel_denoising", action="store_true")
    parser.add_argument("--pixel_noise_ratio", type=float, default=0.0)
    parser.add_argument("--region_denoising", action="store_true")
    parser.add_argument("--region_noise_ratio", type=float, default=0.3)
    parser.add_argument("--super_resolution", action="store_true")
    parser.add_argument("--dense_sr", type=int, default=8)
    parser.add_argument("--label_propagation", action="store_true")
    parser.add_argument("--partial_perc", type=float, default=0.0)
    parser.add_argument("--no_progress", action="store_true")
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--seed", type=int, default=0, help="init / training draws seed")
    parser.add_argument("--coordinator", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd anomaly detection (slow)")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="trace N training steps with torch.profiler "
                        "(<save_dir>/profile/trace.json)")
    return parser.parse_args(argv)


def build_trainer(args):
    """The configuration, bundle and ``Trainer`` (not yet entered) of the
    parsed CLI ``args``."""
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    if args.data_parallel or args.coordinator or args.num_processes or args.process_id is not None:
        raise SystemExit("multi-device and multi-host training are not ported yet "
                         "(ROADMAP queue 1, item 7)")
    cfg = from_yaml(args.config_file)
    data = build_dataset(cfg, args)
    bundle = prepare_bundle(cfg, data, args.device)
    sample_fn = None
    if not cfg.raw.get("render", {}).get("no_batching", True):
        sample_fn = all_images_sample_fn(cfg, bundle)
        print("batching mode: sampling pixels across all training images")
    trainer = Trainer(cfg, bundle, seed=args.seed, device=args.device, sample_fn=sample_fn)
    trainer.profile_steps = args.profile
    return cfg, bundle, trainer


def main(argv=None):
    args = parse_args(argv)
    if args.debug_nans:
        import torch

        torch.autograd.set_detect_anomaly(True)
    _, _, trainer = build_trainer(args)
    with trainer:
        trainer.maybe_resume()
        trainer.fit(n_iters=args.n_iters, progress=not args.no_progress)
    print("training complete")


if __name__ == "__main__":
    main()
