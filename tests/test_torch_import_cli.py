"""The port's import CLI (``intrinsicnerf_tpu_torch/import_reference_ckpt.py``,
twin of ``import_reference_ckpt.py``) and video CLI
(``intrinsicnerf_tpu_torch/video_generator.py``), on the CPU.

- A seeded reference scene ``.ckpt`` (``Semantic_NeRF`` keys) and object
  ``.tar`` (the object ``NeRF``'s ``test_linear*`` / ``shading_linear``
  names), imported into a packed config (8x256, fused) and an unpacked
  one (``use_fused_kernel: false``, or a 4x64 network), through
  ``--config_file`` or ``--save_dir``.
- Each written checkpoint resumes through the port's ``Trainer``: the
  step, the parameters, and a fresh Adam (zero moments, its counts at the
  step).  Its weights equal, exactly, the JAX
  ``intrinsicnerf_tpu/tools/import_ckpt.py:import_reference_checkpoint``
  of the same file (its packed tree for a packed config, its parameter
  tree for an unpacked one).
- The rules of the flags: no ``--save_dir`` and no config is refused.
- The video CLI writes what ``tools/video.py:generate_all`` writes.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from intrinsicnerf_tpu.tools import import_ckpt as jimport
from intrinsicnerf_tpu_torch import config as tconfig
from intrinsicnerf_tpu_torch import import_reference_ckpt, video_generator
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig, PackedMLP
from intrinsicnerf_tpu_torch.tools.import_ckpt import (
    OBJECT_TO_PORT, packed_to_jax, params_to_jax)
from intrinsicnerf_tpu_torch.tools.video import generate_all
from intrinsicnerf_tpu_torch.train.step import DataPools
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, Trainer
from intrinsicnerf_tpu_torch.utils.image import imwrite

STEP = 12_345
N_CLASSES = 5
# (flavor, layout, network (depth, width), how the CLI is told)
CASES = [("scene", "packed", (8, 256), "config"), ("scene", "unpacked", (8, 256), "config"),
         ("object", "packed", (8, 256), "config"), ("object", "unpacked", (4, 64), "save_dir")]


def _reference_file(tmp_path, flavor, depth, width):
    """A reference checkpoint of two seeded networks, in the reference's
    own keys: the scene ``.ckpt`` or the object ``.tar``."""
    semantic = flavor == "scene"
    cfg = MLPConfig(depth=depth, width=width, skips=(4,) if depth > 5 else (depth // 2,),
                    pos_scalar_factor=10.0 if semantic else 1.0, enable_semantic=semantic,
                    num_semantic_classes=N_CLASSES if semantic else 0)
    sds = [IntrinsicMLP(cfg, device="cpu", generator=torch.Generator().manual_seed(s)).state_dict()
           for s in (3, 4)]
    if semantic:
        path = tmp_path / f"{STEP:06d}.ckpt"
        torch.save({"global_step": STEP, "network_coarse_state_dict": sds[0],
                    "network_fine_state_dict": sds[1], "optimizer_state_dict": {}}, path)
        return path, sds
    to_object = {v: k for k, v in OBJECT_TO_PORT.items()}

    def rename(sd):
        out = {}
        for k, v in sd.items():
            mod, _, leaf = k.rpartition(".")
            out[f"{to_object.get(mod, mod)}.{leaf}"] = v
        return out

    path = tmp_path / f"{STEP:06d}.tar"
    torch.save({"global_step": STEP, "network_fn_state_dict": rename(sds[0]),
                "network_fine_state_dict": rename(sds[1])}, path)
    return path, sds


def _config(tmp_path, flavor, layout, save_dir, depth, width):
    """The config a trainer of the imported network reads."""
    if flavor == "scene":
        d = {"experiment": {"save_dir": str(save_dir), "dataset_type": "replica"},
             "model": {"netdepth": depth, "netwidth": width},
             "render": {"N_rays": 16, "N_samples": 4, "N_importance": 4}}
        if layout == "unpacked":
            d["use_fused_kernel"] = False
        path = tmp_path / "scene.yaml"
        path.write_text(yaml.safe_dump(d))
        return path, tconfig.from_yaml(str(path))
    text = (f"expname = {save_dir.name}\nbasedir = {save_dir.parent}\nN_samples = 4\n"
            f"netdepth = {depth}\nnetwidth = {width}\n"
            "N_importance = 4\nN_rand = 16\n"
            + ("use_fused_kernel = False\n" if layout == "unpacked" else ""))
    path = tmp_path / "obj.txt"
    path.write_text(text)
    return path, tconfig.from_object_txt(str(path))


def _bundle(n_classes):
    """The least bundle a ``Trainer`` takes: two 4x4 views."""
    rays = torch.zeros((2, 16, 11))
    rays[..., 5], rays[..., 7] = 1.0, 2.0
    pools = DataPools(rays=rays, rgb=torch.zeros((2, 16, 3)),
                      semantic=torch.zeros((2, 16), dtype=torch.int64),
                      mask_ids=torch.ones(2, dtype=torch.int32))
    return SceneBundle(pools=pools, rays_vis=rays, rays_test=rays, h=4, w=4, h_scaled=4,
                       w_scaled=4, num_valid_classes=n_classes)


@pytest.mark.parametrize("flavor,layout,net,how", CASES)
def test_import_resumes_and_equals_jax(tmp_path, flavor, layout, net, how):
    ref, sds = _reference_file(tmp_path, flavor, *net)
    save_dir = tmp_path / "run"
    obj = ["--object"] if flavor == "object" else []
    cfg_path, cfg = _config(tmp_path, flavor, layout, save_dir, *net)
    told = ["--config_file", str(cfg_path)] if how == "config" else ["--save_dir", str(save_dir)]
    argv = [str(ref), *told, *obj, "--device", "cpu"]
    written = import_reference_ckpt.main(argv)
    assert written == str(save_dir / "checkpoints" / f"{STEP:06d}.ckpt")

    scalar = 10.0 if flavor == "scene" else 1.0
    fused = None if how == "save_dir" else layout == "packed"
    jstate, jmcfg = jimport.import_reference_checkpoint(str(ref), pos_scalar_factor=scalar,
                                                        use_fused_kernel=fused)
    with Trainer(cfg, _bundle(N_CLASSES if flavor == "scene" else 0), device="cpu") as t:
        assert t.mcfg.depth == net[0] and t.mcfg.width == net[1]
        assert t.maybe_resume() == STEP and t.state.step == STEP == int(t.state.step_t)
        models = (t.state.model_coarse, t.state.model_fine)
        assert all(isinstance(m, PackedMLP if layout == "packed" else IntrinsicMLP)
                   for m in models)
        for m, sd in zip(models, sds):  # the reference weights, exactly
            got = m.state_dict()
            assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
        jtrees = (jstate.params_coarse, jstate.params_fine)
        for m, jtree in zip(models, jtrees):
            tree = packed_to_jax(m) if layout == "packed" else params_to_jax(m)
            jflat = {k: np.asarray(v) for k, v in _flatten(jtree).items()}
            pflat = _flatten(tree)
            assert pflat.keys() == jflat.keys()
            for k in jflat:
                assert pflat[k].dtype == jflat[k].dtype and np.array_equal(pflat[k], jflat[k]), k
        adam = t.state.optimizer.state
        for group in t.state.optimizer.param_groups:
            for p in group["params"]:
                assert float(adam[p]["step"]) == STEP
                assert not adam[p]["exp_avg"].any() and not adam[p]["exp_avg_sq"].any()


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_import_needs_a_save_dir_or_a_config(tmp_path):
    ref, _ = _reference_file(tmp_path, "scene", 4, 64)
    with pytest.raises(SystemExit, match="need --save_dir or --config_file"):
        import_reference_ckpt.main([str(ref), "--device", "cpu"])


def test_video_cli_writes_what_generate_all_writes(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        for name in ("rgb", "albedo"):
            imwrite(str(src / f"{name}_{i:03d}.png"),
                    rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
        imwrite(str(src / f"c{i:03d}.png"), rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
    got = video_generator.main(["--img_dir", str(src), "--out_dir", str(tmp_path / "cli"),
                                "--fps", "10"])
    want = generate_all(str(src), str(tmp_path / "lib"), 10)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "rgb.mp4", "albedo.mp4", "c.mp4"]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert video_generator.main(["--img_dir", str(tmp_path / "cli")]) == []
