"""The system under test, as the benchmark reaches it: the port's public
configuration loaders, ``SceneBundle``, ``Trainer`` and ``render_views``.

Every module of the port is looked up when it is called, so a test can
plant a fault underneath a whole run.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from perfbench.reference.config import merged


def framework_config(config: dict, workdir: str):
    """The port's ``FrameworkConfig`` of a benchmark configuration, loaded
    by the port's own loader from a file written in ``workdir`` (the
    scene's YAML, of which JSON is a subset; the object's txt), with the
    run's files under ``workdir``."""
    from intrinsicnerf_tpu_torch import config as port_config

    doc = merged(config)
    if config["format"] == "scene_yaml":
        doc["experiment"]["save_dir"] = os.path.join(workdir, "run")
        path = os.path.join(workdir, "config.yaml")
        with open(path, "w") as f:
            json.dump(doc, f)
        cfg = port_config.from_yaml(path)
    else:
        doc.update(basedir=workdir, expname="run")
        path = os.path.join(workdir, "config.txt")
        with open(path, "w") as f:
            f.writelines(f"{k} = {v!r}\n" for k, v in doc.items())
        cfg = port_config.from_object_txt(path)
    return dataclasses.replace(cfg, raw={})


def mlp_config(cfg, classes: int):
    """The network's configuration with the dataset's class count, as the
    trainer sets it."""
    return dataclasses.replace(cfg.mlp, num_semantic_classes=classes, enable_semantic=classes > 0)


def scene_bundle(config: dict, data: dict, cluster_rays: torch.Tensor):
    """The trainer's ``SceneBundle`` of the seeded training set;
    ``cluster_rays`` are the views a rebuild renders."""
    from intrinsicnerf_tpu_torch.train import step as port_step
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    ds = config["dataset"]
    h, w = ds["height"], ds["width"]
    if ds["kind"] == "scene":
        pools = port_step.DataPools(rays=data["rays"], rgb=data["rgb"], depth=data["depth"],
                                    semantic=data["semantic"], mask_ids=data["mask_ids"])
        return port_trainer.SceneBundle(
            pools=pools, rays_vis=cluster_rays, rays_test=cluster_rays[:0], h=h, w=w,
            h_scaled=h, w_scaled=w, num_valid_classes=ds["semantic_classes"])
    pools = port_step.PosePools(dirs_cam=data["dirs_cam"], poses=data["poses"], rgb=data["rgb"],
                                mask=data["mask"])
    return port_trainer.SceneBundle(
        pools=pools, rays_vis=cluster_rays, rays_test=cluster_rays[:0], h=h, w=w, h_scaled=h,
        w_scaled=w, num_valid_classes=0, rays_cluster=cluster_rays)


def trainer(cfg, config: dict, bundle, seed: int, device):
    """(the port's ``Trainer``, the pair sampler it was given: None for a
    scene, which samples its ray pools)."""
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    sample_fn = (port_trainer.make_object_sample_fn(cfg, bundle)
                 if config["dataset"]["kind"] == "object" else None)
    return (port_trainer.Trainer(cfg, bundle, seed=seed, device=device, sample_fn=sample_fn),
            sample_fn)


def serving_models(mcfg, weights: dict, device):
    """The two levels in the layout training leaves them in, holding
    ``weights``, in eval mode."""
    from intrinsicnerf_tpu_torch.models import mlp as port_mlp
    from intrinsicnerf_tpu_torch.train import step as port_step

    cls = port_mlp.PackedMLP if port_step.packs_state(mcfg) else port_mlp.IntrinsicMLP
    models = {}
    for lvl, leaves in weights.items():
        m = cls(mcfg, device=device)
        m.load_state_dict(leaves)
        models[lvl] = m.eval()
    return models


def load_weights(state, weights: dict) -> None:
    state.model_coarse.load_state_dict(weights["coarse"])
    if state.model_fine is not None:
        state.model_fine.load_state_dict(weights["fine"])


def state_leaves(state) -> dict:
    """Both levels' parameters under the published names, copied."""
    out = {"coarse": state.model_coarse.state_dict()}
    if state.model_fine is not None:
        out["fine"] = state.model_fine.state_dict()
    return {lvl: {k: v.detach().float().clone() for k, v in sd.items()}
            for lvl, sd in out.items()}


def grad_leaves(state) -> dict:
    """The gradients the optimizer got in the last step, under the
    published names."""
    from intrinsicnerf_tpu_torch.models import mlp as port_mlp
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    out = {}
    for lvl, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        if m is None:
            continue
        if isinstance(m, port_mlp.PackedMLP):
            sd = m.unpack(fm.FlatBlocks(m.weight.grad, m.bias.grad))
        else:
            sd = {k: p.grad for k, p in m.named_parameters()}
        out[lvl] = {k: v.detach().float().clone() for k, v in sd.items()}
    return out


def table_copy(table) -> dict:
    """The cluster table the step reads, copied."""
    return {"anchors": table.anchors.clone(), "colors": table.colors.clone(),
            "has_cluster": table.has_cluster.clone(),
            "intensity_factor": float(table.intensity_factor)}


def render_views(models: dict, mcfg, rcfg, rays, h: int, w: int, chunk: int, device):
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    return port_trainer.render_views(models["coarse"], models.get("fine"), mcfg, rcfg, rays, h, w,
                                     chunk, device)
