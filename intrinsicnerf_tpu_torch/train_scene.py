"""Scene-level training entry (Replica), on the GPU.

The port's twin of ``train_scene.py``, with the same flags and defaults:
a YAML config in the original schema, the every-5th train/test split,
then the training loop with its periodic eval, cluster rebuild and
checkpoint work; an existing ``<save_dir>/checkpoints`` is resumed.

    python -m intrinsicnerf_tpu_torch.train_scene --config_file configs/scene/replica_room_0.yaml
    python -m intrinsicnerf_tpu_torch.train_scene --config_file cfg.yaml --device cpu

The ScanNet and Replica-NYU datasets, the five label-degradation
experiments (ROADMAP queue 1, item 6) and the multi-device flags (queue
1, item 7) are not ported yet and raise.
"""

from __future__ import annotations

import argparse

DEGRADATION_FLAGS = ("sparse_views", "pixel_denoising", "region_denoising", "super_resolution",
                     "label_propagation")


def build_dataset(cfg, args):
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split, load_replica

    dstype = cfg.experiment.dataset_type
    if dstype in ("scannet", "replica_nyu_cnn"):
        raise SystemExit(f"dataset_type {dstype!r} is not ported yet (ROADMAP queue 6)")
    if dstype != "replica":
        raise ValueError(f"unknown scene dataset_type: {dstype}")
    for flag in DEGRADATION_FLAGS:
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: the label-degradation experiments are not ported yet "
                             f"(ROADMAP queue 6)")
    train_ids, test_ids = default_replica_split(args.total_frames, args.split_step)
    return load_replica(cfg.experiment.dataset_dir, train_ids, test_ids,
                        img_h=cfg.experiment.height, img_w=cfg.experiment.width)


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


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel or args.coordinator or args.num_processes or args.process_id is not None:
        raise SystemExit("multi-device and multi-host training are not ported yet "
                         "(ROADMAP queue 7)")
    import torch

    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.train.prepare import prepare_replica_bundle
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = from_yaml(args.config_file)
    if not cfg.raw.get("render", {}).get("no_batching", True):
        raise SystemExit("render.no_batching: false (pixels across all images) is not ported "
                         "yet (ROADMAP queue 5)")
    data = build_dataset(cfg, args)
    bundle = prepare_replica_bundle(cfg, data, device=args.device)
    with Trainer(cfg, bundle, seed=args.seed, device=args.device) as trainer:
        trainer.profile_steps = args.profile
        trainer.maybe_resume()
        trainer.fit(n_iters=args.n_iters, progress=not args.no_progress)
    print("training complete")


if __name__ == "__main__":
    main()
