"""Import a reference PyTorch checkpoint into the port's checkpoint.

The port's twin of ``import_reference_ckpt.py``, with the same flags plus
``--device``: the state_dicts of a reference scene ``{:06d}.ckpt`` or
object ``{:06d}.tar`` become ``<save_dir>/checkpoints/{step:06d}.ckpt``
in the port's layout (``train/checkpoint.py``), packed or unpacked as the
config's ``use_fused_kernel`` decides, at the file's step with a fresh
Adam state (``tools/import_ckpt.py:import_reference_checkpoint``).  The
port's ``train_scene``, ``train_object`` and ``extract_mesh`` then resume
from it as they are.

    python -m intrinsicnerf_tpu_torch.import_reference_ckpt 200000.ckpt --save_dir logs/room0
    python -m intrinsicnerf_tpu_torch.import_reference_ckpt 200000.tar --save_dir logs/chair --object
    python -m intrinsicnerf_tpu_torch.import_reference_ckpt 200000.ckpt --config_file cfg.yaml

The architecture comes from the checkpoint's shapes; ``--config_file``
(a scene YAML, or an object txt with ``--object``) supplies the
save_dir, the scene scale and the compute path, so that the written
state is the one a trainer of the same file builds.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="reference .ckpt/.tar path")
    ap.add_argument("--save_dir", default=None,
                    help="experiment dir to write <save_dir>/checkpoints into "
                    "(default: the config's experiment.save_dir)")
    ap.add_argument("--config_file", default=None,
                    help="scene YAML (or object txt with --object) to take save_dir, "
                    "scalar_factor and the compute path from")
    ap.add_argument("--object", action="store_true",
                    help="object-level checkpoint (scalar_factor 1; txt config)")
    ap.add_argument("--scalar_factor", type=float, default=None,
                    help="PE scene-scale divisor (default: 10 scene / 1 object, or the "
                    "config's value)")
    ap.add_argument("--device", default="cuda", help="where the state is built ('cpu': the host)")
    args = ap.parse_args(argv)

    save_dir, scalar = args.save_dir, args.scalar_factor
    compute_dtype = use_fused = None
    if args.config_file:
        from intrinsicnerf_tpu_torch.config import from_object_txt, from_yaml

        cfg = from_object_txt(args.config_file) if args.object else from_yaml(args.config_file)
        save_dir = save_dir or cfg.experiment.save_dir
        if scalar is None:
            scalar = cfg.mlp.pos_scalar_factor
        compute_dtype, use_fused = cfg.mlp.compute_dtype, cfg.mlp.use_fused_kernel
    if save_dir is None:
        raise SystemExit("need --save_dir or --config_file")
    if scalar is None:
        scalar = 1.0 if args.object else 10.0

    from intrinsicnerf_tpu_torch.tools.import_ckpt import import_to_checkpoint
    from intrinsicnerf_tpu_torch.train.step import packs_state

    step, mcfg, path = import_to_checkpoint(args.ckpt, save_dir, scalar, compute_dtype,
                                            use_fused, args.device)
    print(f"imported {args.ckpt} -> {path} @ step {step} "
          f"(D={mcfg.depth} W={mcfg.width} C={mcfg.num_semantic_classes} "
          f"scalar_factor={mcfg.pos_scalar_factor} "
          f"packed={'yes' if packs_state(mcfg) else 'no'})")
    return path


if __name__ == "__main__":
    main()
