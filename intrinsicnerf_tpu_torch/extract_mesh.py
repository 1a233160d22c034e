"""Coloured or semantic mesh extraction from a trained model, on the GPU.

The port's twin of ``extract_mesh.py``, with the same flags plus
``--device``: rebuild the trainer of a scene YAML (``--config_file``) or
an object txt (``--config``), resume its newest checkpoint, query the
fine network's density on a ``grid_dim^3`` grid inside the scene's
bounds (kernel 1 on the card), extract the isosurface at ``--level``,
drop small components, colour the vertices by rendering along their
negative normals (or by the semantic argmax with ``--sem``) and write a
PLY.  An object's data is loaded as Blender data, whatever its config's
dataset type, as the JAX CLI loads it.

    python -m intrinsicnerf_tpu_torch.extract_mesh --config_file cfg.yaml --mesh_file scene/mesh.ply
    python -m intrinsicnerf_tpu_torch.extract_mesh --config configs/object/lego.txt --grid_dim 128
"""

from __future__ import annotations

import argparse
import os
import types


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_file", type=str, default=None, help="scene YAML")
    parser.add_argument("--config", type=str, default=None, help="object txt")
    parser.add_argument("--mesh_file", type=str, default=None,
                        help="scene mesh PLY defining the oriented bounds")
    parser.add_argument("--grid_dim", type=int, default=256)
    parser.add_argument("--level", type=float, default=0.45)
    parser.add_argument("--min_cluster", type=int, default=400,
                        help="drop components with fewer faces; -1 keeps only the largest")
    parser.add_argument("--near_t", type=float, default=1.0)
    parser.add_argument("--sem", action="store_true",
                        help="colour by semantic class instead of rgb")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--total_frames", type=int, default=900)
    parser.add_argument("--split_step", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cpu' runs the kernels' plain versions")
    args = parser.parse_args(argv)
    if (args.config_file is None) == (args.config is None):
        parser.error("pass exactly one of --config_file (scene) / --config (object)")
    return args


def build_trainer(args):
    """(config, ``Trainer``) of the parsed ``args``, its data loaded as the
    training CLI loads it (no label degradation)."""
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    if args.config_file:
        from intrinsicnerf_tpu_torch import train_scene
        from intrinsicnerf_tpu_torch.config import from_yaml

        cfg = from_yaml(args.config_file)
        ds_args = types.SimpleNamespace(total_frames=args.total_frames,
                                        split_step=args.split_step,
                                        **{flag: False for flag in train_scene.DEGRADATION_FLAGS})
        data = train_scene.build_dataset(cfg, ds_args)
        bundle = train_scene.prepare_bundle(cfg, data, args.device)
    else:
        from intrinsicnerf_tpu_torch.config import from_object_txt
        from intrinsicnerf_tpu_torch.data.blender import load_blender_data
        from intrinsicnerf_tpu_torch.train.prepare import prepare_blender_bundle

        cfg = from_object_txt(args.config)
        data = load_blender_data(cfg.experiment.dataset_dir, half_res=cfg.half_res,
                                 testskip=cfg.testskip)
        bundle, _ = prepare_blender_bundle(cfg, data, device=args.device)
    return cfg, Trainer(cfg, bundle, device=args.device)


def main(argv=None, timings=None):
    """Run the CLI; ``timings``, a dict, receives the extraction's stage
    seconds.  Returns the output path."""
    from intrinsicnerf_tpu_torch.geometry.mesh import extract_colour_mesh, read_ply

    args = parse_args(argv)
    cfg, trainer = build_trainer(args)
    with trainer:
        step = trainer.maybe_resume()
        if step == 0:
            print("WARNING: no checkpoint found: extracting from the random initialisation")
        scene_points = read_ply(args.mesh_file)[0] if args.mesh_file else None
        out = args.out or os.path.join(
            cfg.experiment.save_dir,
            f"{'semantic' if args.sem else 'colour'}_mesh_dim{args.grid_dim}_step{step}.ply")
        extract_colour_mesh(trainer, scene_points=scene_points, grid_dim=args.grid_dim,
                            level=args.level, min_cluster_faces=args.min_cluster,
                            near_t=args.near_t, color_mode="semantic" if args.sem else "rgb",
                            out_path=out, timings=timings)
    return out


if __name__ == "__main__":
    main()
