"""Unified typed configuration (port of ``intrinsicnerf_tpu/config.py``).

Loads both reference config systems into one ``FrameworkConfig``: YAML
with sections ``experiment/model/render/train/logging`` for scenes (with
arithmetic strings like ``"32*16"``) and configargparse ``key = value``
txt files for objects.  ``compute_dtype`` maps to a torch dtype.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
from intrinsicnerf_tpu_torch.train.step import TrainConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _fused_kernel_default(depth: int, width: int, use_viewdirs: bool) -> bool:
    """The fused MLP kernel is the default for the reference architecture
    (D=8, W=256, skip@4, viewdirs) it implements."""
    return depth == 8 and width == 256 and use_viewdirs


def _arith(v):
    """Evaluate arithmetic config strings like '32*16' safely."""
    if isinstance(v, str):
        node = ast.parse(v, mode="eval")
        for sub in ast.walk(node):
            if not isinstance(
                sub, (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
                      ast.operator, ast.unaryop)
            ):
                raise ValueError(f"non-arithmetic config expression: {v!r}")
        return eval(compile(node, "<config>", "eval"))
    return v


@dataclasses.dataclass
class ExperimentConfig:
    save_dir: str = "logs/exp"
    dataset_type: str = "replica"  # replica | scannet | replica_nyu_cnn |
    # blender | blender_intrinsic | llff
    dataset_dir: str = ""
    scene_file: str = ""  # replica semantic_info dir
    scene_name: str = ""  # scannet scene id
    convention: str = "opencv"
    width: int = 320
    height: int = 240
    enable_semantic: bool = True
    enable_depth: bool = True
    endpoint_feat: bool = False
    nyu_mode: str = "nyu13"


@dataclasses.dataclass
class LoggingConfig:
    step_log_print: int = 1000
    step_log_tfb: int = 1000
    step_save_ckpt: int = 10000
    step_val: int = 50000
    step_vis_train: int = 10000


@dataclasses.dataclass
class FrameworkConfig:
    experiment: ExperimentConfig
    mlp: MLPConfig
    render: RenderConfig
    train: TrainConfig
    logging: LoggingConfig
    depth_range: Tuple[float, float] = (0.1, 10.0)
    test_viz_factor: int = 1
    chunk: int = 32 * 1024  # eval-render chunk (rays per render_rays call)
    b_f_cap: float = 1.0  # bandwidth anneal cap (0.5 for objects)
    half_res: bool = False
    testskip: int = 8
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    compute_dtype: str = "bfloat16"
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)


def from_yaml(path: str, overrides: Optional[Dict[str, Any]] = None) -> FrameworkConfig:
    """Load a scene config in the reference's YAML schema."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if overrides:
        for k, v in overrides.items():
            sec, _, key = k.partition(".")
            if key:
                cfg.setdefault(sec, {})[key] = v
            else:
                cfg[sec] = v

    exp = cfg.get("experiment", {})
    model = cfg.get("model", {})
    render = cfg.get("render", {})
    train = cfg.get("train", {})
    log = cfg.get("logging", {})

    experiment = ExperimentConfig(
        save_dir=exp.get("save_dir", "logs/exp"),
        dataset_type=exp.get("dataset_type", "replica"),
        dataset_dir=exp.get("dataset_dir", ""),
        scene_file=exp.get("scene_file", ""),
        scene_name=exp.get("scene_name", ""),
        convention=exp.get("convention", "opencv"),
        width=int(exp.get("width", 320)),
        height=int(exp.get("height", 240)),
        enable_semantic=bool(exp.get("enable_semantic", True)),
        enable_depth=bool(exp.get("enable_depth", True)),
        endpoint_feat=bool(exp.get("endpoint_feat", False)),
        nyu_mode=exp.get("nyu_mode", "nyu13"),
    )
    depth = int(model.get("netdepth", 8))
    width = int(model.get("netwidth", 256))
    use_viewdirs = bool(render.get("use_viewdirs", True))
    mlp = MLPConfig(
        depth=depth,
        width=width,
        skips=(4,) if depth > 5 else (depth // 2,),
        n_freqs_pos=int(render.get("multires", 10)),
        n_freqs_dir=int(render.get("multires_views", 4)),
        pos_scalar_factor=float(cfg.get("pos_scalar_factor", 10.0)),
        use_viewdirs=use_viewdirs,
        enable_semantic=experiment.enable_semantic,
        num_semantic_classes=0,  # filled in from the dataset
        compute_dtype=_DTYPES[str(cfg.get("compute_dtype", "bfloat16"))],
        use_fused_kernel=bool(
            cfg.get("use_fused_kernel", _fused_kernel_default(depth, width,
                                                              use_viewdirs))
        ),
    )
    rcfg = RenderConfig(
        n_coarse=int(render.get("N_samples", 64)),
        n_importance=int(render.get("N_importance", 128)),
        perturb=float(render.get("perturb", 1.0)),
        raw_noise_std=float(render.get("raw_noise_std", 0.0)),
        white_bkgd=bool(render.get("white_bkgd", False)),
        lindisp=bool(render.get("lindisp", False)),
        endpoint_feat=experiment.endpoint_feat,
    )
    tcfg = TrainConfig(
        n_rays=int(_arith(render.get("N_rays", 512))),
        lrate=float(train.get("lrate", 5e-4)),
        lrate_decay=float(train.get("lrate_decay", 250e3)),
        n_iters=int(train.get("N_iters", 200000)),
        wgt_sem=float(train.get("wgt_sem", 4e-2)),
        w_n=float(train.get("w_n", 0.01)),
        w_f=float(train.get("w_f", 0.005)),
        w_s=float(train.get("w_s", 1.0)),
        w_res1=float(train.get("w_res1", 1.0)),
        w_res2=float(train.get("w_res2", 0.02)),
        w_i1=float(train.get("w_i1", 0.1)),
        w_i2=float(train.get("w_i2", 0.01)),
        no_cluster=bool(train.get("no_cluster", False)),
        no_semantic_tree=bool(train.get("no_semantic_tree", False)),
        no_intrinsic_loss=bool(train.get("no_intrinsic_loss", False)),
        mask_mode=cfg.get("mask_mode", "label"),
        steps_per_call=int(train.get("steps_per_call", 1)),
    )
    lcfg = LoggingConfig(
        step_log_print=int(_arith(log.get("step_log_print", 1000))),
        step_log_tfb=int(_arith(log.get("step_log_tfb", 1000))),
        step_save_ckpt=int(_arith(log.get("step_save_ckpt", 10000))),
        step_val=int(_arith(log.get("step_val", 50000))),
        step_vis_train=int(_arith(log.get("step_vis_train", 10000))),
    )
    return FrameworkConfig(
        experiment=experiment,
        mlp=mlp,
        render=rcfg,
        train=tcfg,
        logging=lcfg,
        depth_range=tuple(render.get("depth_range", (0.1, 10.0))),
        test_viz_factor=int(render.get("test_viz_factor", 1)),
        chunk=int(_arith(model.get("chunk", 32 * 1024))),
        b_f_cap=float(cfg.get("b_f_cap", 1.0)),
        raw=cfg,
    )


def from_object_txt(
    path: str, overrides: Optional[Dict[str, Any]] = None
) -> FrameworkConfig:
    """Load an object-level config (configargparse ``key = value`` txt)."""
    cfg: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or "=" not in line:
                continue
            k, v = (x.strip() for x in line.split("=", 1))
            try:
                cfg[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                cfg[k] = v
    if overrides:
        cfg.update(overrides)

    experiment = ExperimentConfig(
        save_dir=os.path.join(
            str(cfg.get("basedir", "./logs")), str(cfg.get("expname", "exp"))
        ),
        dataset_type=str(cfg.get("dataset_type", "blender")),
        dataset_dir=str(cfg.get("datadir", "")),
        convention="opengl",
        enable_semantic=False,
        enable_depth=False,
    )
    depth = int(cfg.get("netdepth", 8))
    width = int(cfg.get("netwidth", 256))
    use_viewdirs = bool(cfg.get("use_viewdirs", True))
    mlp = MLPConfig(
        depth=depth,
        width=width,
        skips=(4,) if depth > 5 else (depth // 2,),
        n_freqs_pos=int(cfg.get("multires", 10)),
        n_freqs_dir=int(cfg.get("multires_views", 4)),
        pos_scalar_factor=1.0,
        use_viewdirs=use_viewdirs,
        enable_semantic=False,
        compute_dtype=_DTYPES[str(cfg.get("compute_dtype", "bfloat16"))],
        use_fused_kernel=bool(
            cfg.get("use_fused_kernel", _fused_kernel_default(depth, width,
                                                              use_viewdirs))
        ),
    )
    rcfg = RenderConfig(
        n_coarse=int(cfg.get("N_samples", 64)),
        n_importance=int(cfg.get("N_importance", 128)),
        perturb=float(cfg.get("perturb", 1.0)),
        raw_noise_std=float(cfg.get("raw_noise_std", 0.0)),
        white_bkgd=bool(cfg.get("white_bkgd", False)),
        lindisp=bool(cfg.get("lindisp", False)),
    )
    tcfg = TrainConfig(
        n_rays=int(cfg.get("N_rand", 1024)),
        lrate=float(cfg.get("lrate", 5e-4)),
        lrate_decay=float(cfg.get("lrate_decay", 250)) * 1000.0,  # object semantics
        n_iters=int(cfg.get("N_iters", 200000)),
        w_n=float(cfg.get("w_r", 0.02)),
        w_f=float(cfg.get("w_f", 0.01)),
        w_s=float(cfg.get("w_s", 1.0)),
        w_res1=float(cfg.get("w_res1", 1.0)),
        w_res2=float(cfg.get("w_res2", 0.02)),
        w_i1=float(cfg.get("w_i1", 0.1)),
        w_i2=float(cfg.get("w_i2", 0.01)),
        no_cluster=bool(cfg.get("no_cluster", False)),
        no_semantic_tree=True,
        no_intrinsic_loss=bool(cfg.get("no_intrinsic_loss", False)),
        mask_mode="mask",
        steps_per_call=int(cfg.get("steps_per_call", 1)),
    )
    lcfg = LoggingConfig(
        step_log_print=int(cfg.get("i_print", 100)),
        step_log_tfb=int(cfg.get("i_print", 100)),
        step_save_ckpt=int(cfg.get("i_weights", 10000)),
        step_val=int(cfg.get("i_testset", 10000)),
        step_vis_train=int(cfg.get("i_testset", 10000)),
    )
    return FrameworkConfig(
        experiment=experiment,
        mlp=mlp,
        render=rcfg,
        train=tcfg,
        logging=lcfg,
        depth_range=(2.0, 6.0),  # blender defaults
        chunk=int(cfg.get("chunk", 32 * 1024)),
        b_f_cap=0.5,  # object anneal cap
        half_res=bool(cfg.get("half_res", False)),
        testskip=int(cfg.get("testskip", 8)),
        precrop_iters=int(cfg.get("precrop_iters", 0)),
        precrop_frac=float(cfg.get("precrop_frac", 0.5)),
        raw=cfg,
    )
