"""Mesh extraction of the PyTorch port against the JAX package (CPU).

- PLY: the port's bytes equal the JAX writer's; each reader reads the
  other's file back;
- ``oriented_bounds``, ``grid_within_bound``, ``vertex_normals``: within
  1e-6 (the same numpy arithmetic);
- ``query_density_grid`` of a small seeded model (4x32, unfused fp32, C =
  5): occupancy within 1e-5 of the JAX query (the same fp32 network, sums
  in another order), the labels equal where the two best logits are
  1e-4 apart;
- ``marching_cubes`` and ``filter_small_components``: the same grid in
  both packages (and through the port's numpy versions) gives identical
  vertices, triangles and masks;
- ``extract_colour_mesh`` at grid_dim 20 with the level at the grid's
  median: the same triangles, vertices within 1e-4 and colours within one
  8-bit step of the JAX extraction's;
- the CLI (``python -m intrinsicnerf_tpu_torch.extract_mesh``) on the CPU
  from a scene and an object checkpoint written by the port's training
  CLIs.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from intrinsicnerf_tpu import native as jnative
from intrinsicnerf_tpu.core.rays import create_rays as j_create_rays
from intrinsicnerf_tpu.geometry import mesh as jmesh
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu_torch import extract_mesh as cli
from intrinsicnerf_tpu_torch import native as tnative
from intrinsicnerf_tpu_torch import train_object, train_scene
from intrinsicnerf_tpu_torch.data.blender import pose_spherical
from intrinsicnerf_tpu_torch.geometry import mesh as tmesh
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_to_jax
from intrinsicnerf_tpu_torch.utils.image import imwrite

MLP_KW = dict(depth=4, width=32, skips=(2,), n_freqs_pos=6, n_freqs_dir=3, pos_scalar_factor=1.0,
              enable_semantic=True, num_semantic_classes=5)
NEAR, FAR = 0.5, 4.0


def _mesh(rng, n_v=40, n_f=70):
    v = rng.normal(size=(n_v, 3)).astype(np.float32)
    f = rng.integers(0, n_v, size=(n_f, 3))
    return v, f, rng.integers(0, 256, size=(n_v, 3)).astype(np.uint8), \
        rng.normal(size=(n_v, 3)).astype(np.float32)


@pytest.mark.parametrize("parts", ["all", "no_normals", "no_colors", "vertices_only"])
def test_write_ply_bytes_equal_jax(tmp_path, parts):
    v, f, c, n = _mesh(np.random.default_rng(1))
    kw = dict(faces=None if parts == "vertices_only" else f,
              colors=None if parts in ("no_colors", "vertices_only") else c,
              normals=None if parts in ("no_normals", "vertices_only") else n)
    tmesh.write_ply(str(tmp_path / "t.ply"), v, **kw)
    jmesh.write_ply(str(tmp_path / "j.ply"), v, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for reader in (tmesh.read_ply, jmesh.read_ply):
        verts, faces = reader(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(verts, v)
        if kw["faces"] is None:
            assert faces is None
        else:
            np.testing.assert_array_equal(faces, f)


def test_read_ply_ascii_matches_jax(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                    "property float z\nproperty uchar red\nelement face 1\n"
                    "property list uchar int vertex_indices\nend_header\n"
                    "0 0 0 5\n1 0 0 6\n0 1 0.5 7\n3 0 1 2\n")
    (vt, ft), (vj, fj) = tmesh.read_ply(str(path)), jmesh.read_ply(str(path))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("seed", [0, 1])
def test_bounds_grid_and_normals_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(200, 3)) * [3.0, 1.0, 0.3] + [1.0, -2.0, 0.5]
    (tt, et), (tj, ej) = tmesh.oriented_bounds(pts), jmesh.oriented_bounds(pts)
    np.testing.assert_allclose(tt, tj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(et, ej, atol=1e-6, rtol=0)
    (gt, st), (gj, sj) = (tmesh.grid_within_bound([-1.0, 1.0], et, tt, 9),
                          jmesh.grid_within_bound([-1.0, 1.0], ej, tj, 9))
    np.testing.assert_allclose(gt, gj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
    v, f, _, _ = _mesh(rng)
    np.testing.assert_allclose(tmesh.vertex_normals(v, f), jmesh.vertex_normals(v, f), atol=1e-6,
                               rtol=0)


def _models(seed=3, lift=3.0):
    """Coarse and fine port models (sigma bias raised by ``lift`` so that
    the field has a surface) and their JAX parameters."""
    g = torch.Generator().manual_seed(seed)
    cfg = tm.MLPConfig(**MLP_KW)
    models = [tm.IntrinsicMLP(cfg, device="cpu", generator=g) for _ in range(2)]
    for m in models:
        with torch.no_grad():
            m.alpha_linear.bias += lift
    return cfg, jm.MLPConfig(**MLP_KW), models, [params_to_jax(m) for m in models]


def test_query_density_grid_matches_jax():
    tcfg, jcfg, (_, mf), (_, pf) = _models()
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.5, 1.5, size=(5000, 3)).astype(np.float32)
    occ_t, sem_t = tmesh.query_density_grid(mf, tcfg, pts, 0.05, chunk=1024)
    occ_j, sem_j = jmesh.query_density_grid(pf, jcfg, pts, 0.05, chunk=1024)
    np.testing.assert_allclose(occ_t, np.asarray(occ_j), atol=1e-5, rtol=0)
    assert 0.05 < occ_t.mean() < 0.95
    with torch.no_grad():
        raw = tm.eval_points(mf, tcfg, torch.from_numpy(pts)[:, None], torch.zeros(len(pts), 3))
    top2 = torch.topk(raw.sem_logits[:, 0], 2).values
    clear = (top2[:, 0] - top2[:, 1]).numpy() > 1e-4
    np.testing.assert_array_equal(sem_t[clear], np.asarray(sem_j)[clear])


@pytest.mark.parametrize("seed", [0, 1])
def test_marching_and_component_filter_match_jax(seed):
    rng = np.random.default_rng(seed)
    # two blobs and noise: several components of different sizes
    x = np.linspace(-1, 1, 14)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    grid = (np.exp(-((gx - 0.4) ** 2 + gy ** 2 + gz ** 2) * 8)
            + np.exp(-((gx + 0.5) ** 2 + (gy - 0.3) ** 2 + gz ** 2) * 20)
            + 0.2 * rng.random(gx.shape)).astype(np.float32)
    vt, ft = tnative.marching_cubes(grid, 0.45)
    vj, fj = jnative.marching_cubes(grid, 0.45)
    vn, fn = tnative._marching_tetrahedra_np(grid, 0.45)
    assert len(ft) > 100
    for v, f in ((vj, fj), (vn, fn)):
        np.testing.assert_array_equal(vt, v)
        np.testing.assert_array_equal(ft, f)
    for min_faces in (-1, 5, 60):
        keep = tnative.filter_small_components(ft, len(vt), min_faces)
        np.testing.assert_array_equal(keep, jnative.filter_small_components(ft, len(vt), min_faces))
        np.testing.assert_array_equal(keep, tnative._filter_components_np(ft, len(vt), min_faces))
        assert 0 < keep.sum() <= len(ft)
    assert tnative.mesh_backend() in ("native C++", "numpy")


def _trainers():
    """Stand-ins for the two packages' trainers: what
    ``extract_colour_mesh`` reads (config, models, test-view rays)."""
    tcfg, jcfg, (mc, mf), (pc, pf) = _models()
    poses = np.stack([pose_spherical(a, -20.0, 2.5) for a in (0.0, 120.0, 240.0)])
    rays = np.array(j_create_rays(jnp.asarray(poses, jnp.float32), 4, 4, 3.0, 3.0, 1.5, 1.5,
                                   NEAR, FAR, convention="opengl"))
    kw = dict(n_coarse=8, n_importance=8, perturb=0.0, raw_noise_std=0.0)
    bundle = dict(colour_map=None, num_valid_classes=MLP_KW["num_semantic_classes"])
    jt = types.SimpleNamespace(
        cfg=types.SimpleNamespace(depth_range=(NEAR, FAR), render=jp.RenderConfig(**kw)),
        mcfg=jcfg, state=types.SimpleNamespace(params_coarse=pc, params_fine=pf),
        bundle=types.SimpleNamespace(rays_test=rays, **bundle))
    tt = types.SimpleNamespace(
        cfg=types.SimpleNamespace(depth_range=(NEAR, FAR), render=tp.RenderConfig(**kw)),
        mcfg=tcfg, state=types.SimpleNamespace(model_coarse=mc, model_fine=mf),
        bundle=types.SimpleNamespace(rays_test=torch.from_numpy(rays), **bundle))
    return jt, tt


@pytest.mark.parametrize("color_mode", ["rgb", "semantic"])
def test_extract_colour_mesh_matches_jax(tmp_path, color_mode):
    jt, tt = _trainers()
    dim = 20
    # the level at the grid's median occupancy: about half the grid inside
    origins = tt.bundle.rays_test[:, 0, 0:3].numpy()
    span = max(np.ptp(origins, axis=0).max(), 1.0) * 2.5
    corners = origins.mean(0) + span / 2 * np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
    transform, extents = tmesh.oriented_bounds(corners)
    pts, _ = tmesh.grid_within_bound([-1.0, 1.0], extents, transform, dim)
    occ, _ = tmesh.query_density_grid(tt.state.model_fine, tt.mcfg, pts, (FAR - NEAR) / 8)
    level = float(np.median(occ))
    kw = dict(grid_dim=dim, level=level, min_cluster_faces=10, color_mode=color_mode)
    timings = {}
    vt, ft, ct = tmesh.extract_colour_mesh(tt, out_path=str(tmp_path / "t.ply"), timings=timings,
                                           **kw)
    vj, fj, cj = jmesh.extract_colour_mesh(jt, out_path=str(tmp_path / "j.ply"), **kw)
    assert len(ft) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-4, rtol=0)
    assert np.abs(ct.astype(int) - cj.astype(int)).max() <= 1
    assert sorted(timings) == ["march_s", "mesh_backend", "query_s", "render_rays", "render_s",
                               "write_s"]
    assert timings["render_rays"] == len(vt)
    verts, faces = tmesh.read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(verts, vt.astype(np.float32))
    np.testing.assert_array_equal(faces, ft)


# ---- the CLI ------------------------------------------------------------------


def _room(root, n=8, h=12, w=16):
    """A tiny Replica directory: two coloured halves at 2.5 m, 8 poses."""
    for sub in ("rgb", "depth", "semantic_class"):
        (root / sub).mkdir(parents=True)
    traj = []
    for i in range(n):
        rgb = np.zeros((h, w, 3), np.uint8)
        rgb[:, : w // 2], rgb[:, w // 2:] = [180, 60, 40], [40, 120, 200]
        sem = np.zeros((h, w), np.uint8)
        sem[:, : w // 2], sem[:, w // 2:] = 3, 7
        imwrite(str(root / "rgb" / f"rgb_{i}.png"), rgb)
        imwrite(str(root / "depth" / f"depth_{i}.png"), np.full((h, w), 2500, np.uint16))
        imwrite(str(root / "semantic_class" / f"semantic_class_{i}.png"), sem)
        pose = np.eye(4)
        pose[0, 3], pose[2, 3] = 0.3 * i, -3.0 - 0.05 * i
        traj.append(pose.reshape(-1))
    np.savetxt(str(root / "traj_w_c.txt"), np.stack(traj), delimiter=" ")


def test_extract_mesh_cli_on_a_scene_checkpoint(tmp_path, capsys):
    _room(tmp_path / "data")
    cfg = {"experiment": {"save_dir": str(tmp_path / "run"), "dataset_dir": str(tmp_path / "data"),
                          "dataset_type": "replica", "convention": "opencv", "width": 16,
                          "height": 12, "enable_semantic": True, "enable_depth": True},
           "model": {"netdepth": 3, "netwidth": 32, "chunk": 1024, "netchunk": 1024},
           "render": {"N_rays": 16, "N_samples": 8, "N_importance": 8, "perturb": 1,
                      "use_viewdirs": True, "multires": 4, "multires_views": 2,
                      "raw_noise_std": 1, "test_viz_factor": 1, "depth_range": [0.1, 10.0]},
           "train": {"N_iters": 4},
           "logging": {"step_log_tfb": 4, "step_save_ckpt": 4, "step_val": 100,
                       "step_vis_train": 100}}
    path = tmp_path / "scene.yaml"
    path.write_text(yaml.dump(cfg))
    split = ["--total_frames", "8", "--split_step", "4"]
    train_scene.main(["--config_file", str(path), "--device", "cpu", "--no_progress", *split])
    out = cli.main(["--config_file", str(path), "--device", "cpu", "--grid_dim", "16",
                    "--level", "0.0001", "--min_cluster", "1", *split])
    said = capsys.readouterr().out
    assert "resumed from step 4" in said and "wrote" in said
    assert os.path.basename(out) == "colour_mesh_dim16_step4.ply"
    verts, faces = tmesh.read_ply(out)
    assert len(verts) > 0 and len(faces) > 0 and faces.max() < len(verts)
    assert np.isfinite(verts).all()


def test_extract_mesh_cli_on_an_object_checkpoint(tmp_path, capsys):
    root = tmp_path / "object"
    frames = {}
    for split, n in (("train", 2), ("val", 1), ("test", 2)):
        frames[split] = []
        (root / split).mkdir(parents=True)
        for i in range(n):
            rgba = np.full((16, 16, 4), 255, np.uint8)
            rgba[4:12, 4:12, :3] = [200, 40, 40]
            imwrite(str(root / split / f"r_{i}.png"), rgba)
            frames[split].append({"file_path": f"./{split}/r_{i}", "transform_matrix":
                                  pose_spherical(90.0 * i + 30, -30.0, 4.0).tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.6911, "frames": frames[split]}))
    txt = {"expname": "tiny", "basedir": str(tmp_path), "datadir": str(root),
           "dataset_type": "blender", "use_viewdirs": True, "white_bkgd": True, "netdepth": 3,
           "netwidth": 32, "N_samples": 8, "N_importance": 8, "N_rand": 16, "testskip": 1,
           "i_print": 2, "i_weights": 2, "i_testset": 100, "chunk": 128}
    path = tmp_path / "tiny.txt"
    path.write_text("\n".join(f"{k} = {v}" for k, v in txt.items()))
    train_object.main(["--config", str(path), "--device", "cpu", "--n_iters", "2",
                       "--no_progress"])
    out = cli.main(["--config", str(path), "--device", "cpu", "--grid_dim", "12", "--level",
                    "0.0001", "--min_cluster", "-1", "--out", str(tmp_path / "obj.ply")])
    assert "resumed from step 2" in capsys.readouterr().out
    verts, faces = tmesh.read_ply(out)
    assert len(faces) > 0 and faces.max() < len(verts)


def test_extract_mesh_cli_needs_one_config():
    with pytest.raises(SystemExit):
        cli.parse_args(["--grid_dim", "8"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--config", "a.txt", "--config_file", "b.yaml"])
