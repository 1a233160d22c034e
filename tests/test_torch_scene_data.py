"""The other scene data of the PyTorch port against the JAX package (CPU):
the ScanNet and Replica-NYU loaders, the five label degradations, the
ScanNet and NYU bundles, the all-images sampler, one ScanNet-config step
and the scene CLI on them.

The fixtures are the synthetic room of ``tools_make_synthetic_replica.py``
at 48x36, written in the ScanNet layout (96x72 frames, one frame with a
non-finite pose, one label pixel past the tsv's largest raw id) and in
the Replica-NYU layout by ``tools/synthetic_replica.py``.  Tolerances:

- loaders: images, depth and labels equal exactly (both packages decode
  with OpenCV), poses and intrinsics within 1e-6;
- degradations: labels and ``mask_ids`` equal exactly (the same
  ``np.random.RandomState`` calls);
- bundles: within 1e-6 (the same fp32 ray arithmetic), palettes, names
  and class ids equal;
- the all-images sampler: the JAX key splits reproduced here, their
  integer draws fed to ``gather_ray_pairs_all_images``; labels exactly,
  rays, rgb and depth within 1e-6;
- one step at the ScanNet config (8x256, skip 4, view directions, fused,
  C = 40): the bounds of ``tests/test_torch_train.py``'s fused step (loss
  terms within 1e-3 relative, per-level gradient cosine > 0.999).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from intrinsicnerf_tpu import config as jconfig
from intrinsicnerf_tpu.data import degradations as jdeg
from intrinsicnerf_tpu.data import replica as jrep
from intrinsicnerf_tpu.data import replica_nyu as jnyu
from intrinsicnerf_tpu.data import samplers as js
from intrinsicnerf_tpu.data import scannet as jscan
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.tools import import_ckpt as jimport
from intrinsicnerf_tpu.train import prepare as jprep
from intrinsicnerf_tpu.utils import image as jimage
from intrinsicnerf_tpu_torch import config as tconfig
from intrinsicnerf_tpu_torch import train_scene
from intrinsicnerf_tpu_torch.data import degradations as tdeg
from intrinsicnerf_tpu_torch.data import replica as trep
from intrinsicnerf_tpu_torch.data import replica_nyu as tnyu
from intrinsicnerf_tpu_torch.data import samplers as ts
from intrinsicnerf_tpu_torch.data import scannet as tscan
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.tools import synthetic_replica as syn
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_to_jax
from intrinsicnerf_tpu_torch.train import prepare as tprep
from intrinsicnerf_tpu_torch.utils import image as timage
from intrinsicnerf_tpu_torch.utils.image import imread, imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANNET_CONFIG = os.path.join(ROOT, "configs", "scene", "scannet_template.yaml")
FRAMES, RW, RH = 12, 48, 36  # the room: 12 frames at 48x36
SW, SH = 96, 72  # the ScanNet frames
SCENE = "scene0000_00"
BAD_POSE_FRAME = 4  # its pose is written non-finite


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    root = tmp_path_factory.mktemp("room")
    syn.write_synthetic_replica(str(root / "replica"), FRAMES, RW, RH)
    scan = root / "scan"
    syn.write_scannet_from_replica(str(root / "replica"), str(scan), SCENE, size=(SW, SH))
    pose = np.loadtxt(scan / "renders" / "pose" / f"{BAD_POSE_FRAME}.txt")
    pose[0, 0] = -np.inf  # as ScanNet marks a lost track
    np.savetxt(scan / "renders" / "pose" / f"{BAD_POSE_FRAME}.txt", pose)
    label = scan / f"{SCENE}_2d-label-filt" / "label-filt" / "0.png"
    lab = imread(str(label))
    lab[3, 5] = 999  # past the tsv's largest raw id: clipped before the remap
    imwrite(str(label), lab)
    syn.write_replica_nyu_from_replica(str(root / "replica"), str(root / "nyu"))
    return root


def _same_samples(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        if k == "T_wc":
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t[k].dtype == j[k].dtype, k


# ---- loaders -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["nyu40", "nyu13"])
@pytest.mark.parametrize("size", [(None, None), (27, 36)], ids=["native", "resized"])
def test_scannet_loader_matches_jax(room, mode, size):
    h, w = size
    j = jscan.load_scannet(str(room / "scan"), SCENE, mode=mode, img_h=h, img_w=w)
    t = tscan.load_scannet(str(room / "scan"), SCENE, mode=mode, img_h=h, img_w=w)
    _same_samples(t.train_samples, j.train_samples)
    _same_samples(t.test_samples, j.test_samples)
    assert (t.train_ids, t.test_ids) == (j.train_ids, j.test_ids)
    # 11 frames with a finite pose: train 0, 5, 10; test 2, 7 (12 runs past the end)
    assert (t.train_ids, t.test_ids) == ([0, 5, 10], [2, 7])
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.semantic_classes, j.semantic_classes)
    assert t.num_semantic_class == j.num_semantic_class
    np.testing.assert_array_equal(t.mask_ids, j.mask_ids)
    # colour and labels padded to 4:3, the depth not
    if h is None:
        assert t.train_samples["image"].shape[1:] == (SH + 4, SW, 3)
        assert t.train_samples["depth"].shape[1:] == (SH, SW)


def test_scannet_nyu13_table_and_mappings_match_jax(room):
    np.testing.assert_array_equal(tscan.NYU40_TO_NYU13, jscan.NYU40_TO_NYU13)
    d = str(room / "scan")
    assert tscan.load_scannet_nyu40_mapping(d) == jscan.load_scannet_nyu40_mapping(d)
    assert tscan.load_scannet_nyu13_mapping(d) == jscan.load_scannet_nyu13_mapping(d)


@pytest.mark.parametrize("mode", ["nyu13", "nyu34", "gt_nyu13"])
def test_replica_nyu_loader_matches_jax(room, mode):
    tr, te = jrep.default_replica_split(FRAMES, 4)
    j = jnyu.load_replica_nyu_cnn(str(room / "nyu"), tr, te, nyu_mode=mode, img_h=27, img_w=36)
    t = tnyu.load_replica_nyu_cnn(str(room / "nyu"), tr, te, nyu_mode=mode, img_h=27, img_w=36)
    _same_samples(t.train_samples, j.train_samples)
    _same_samples(t.test_samples, j.test_samples)
    assert (t.num_semantic_class, t.nyu_mode) == (j.num_semantic_class, j.nyu_mode)
    np.testing.assert_array_equal(t.mask_ids, j.mask_ids)
    cnn, gt = t.train_samples["semantic_remap"], t.train_samples["semantic_remap_clean"]
    assert (cnn != gt).any() == (mode != "gt_nyu13")


def test_nyu_palettes_and_names_match_jax():
    for name in ("nyu13_colour_code", "nyu40_colour_code", "nyu34_colour_code"):
        a, b = getattr(timage, name), getattr(jimage, name)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert timage.nyu13_class_names == jimage.nyu13_class_names
    assert timage.nyu34_class_names == jimage.nyu34_class_names


# ---- degradations -------------------------------------------------------


def _replica_pair(room):
    tr, te = jrep.default_replica_split(FRAMES, 3)
    args = (str(room / "replica"), tr, te, 27, 36)
    return jrep.load_replica(*args), trep.load_replica(*args)


def _degrade(mod, data, mode, seed):
    if mode == "sparse_even":
        mod.sample_label_maps(data, sparse_ratio=0.5, random_sample=False, seed=seed)
    elif mode == "sparse_random":
        mod.sample_label_maps(data, sparse_ratio=0.5, random_sample=True, seed=seed)
    elif mode == "pixel":
        mod.sample_label_maps(data, sparse_ratio=0.25, random_sample=True, seed=seed)
        mod.add_pixel_wise_noise_label(data, noise_ratio=0.3, seed=seed)
    elif mode == "region":
        mod.add_instance_wise_noise_label(data, data.train_samples["instance"], flip_ratio=0.5,
                                          seed=seed)
    elif mode == "super_resolution":
        mod.super_resolve_label(data, down_scale_factor=2 + 2 * seed)
    elif mode == "click":
        mod.simulate_user_click_partial(data, perc=0.02, seed=seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["sparse_even", "sparse_random", "pixel", "region",
                                  "super_resolution", "click"])
def test_degradations_match_jax(room, mode, seed):
    j, t = _replica_pair(room)
    clean = t.train_samples["semantic_remap"].copy()
    _degrade(jdeg, j, mode, seed)
    _degrade(tdeg, t, mode, seed)
    np.testing.assert_array_equal(t.mask_ids, j.mask_ids)
    np.testing.assert_array_equal(t.train_samples["semantic_remap"],
                                  j.train_samples["semantic_remap"])
    np.testing.assert_array_equal(t.train_samples["semantic_remap_clean"], clean)
    changed = (t.train_samples["semantic_remap"] != clean).any()
    assert changed == (mode not in ("sparse_even", "sparse_random"))
    assert (t.mask_ids == 0).any() == (mode in ("sparse_even", "sparse_random", "pixel"))


# ---- bundles ------------------------------------------------------------


def _scene_cfg(tmp_path, data_dir, dstype, nyu_mode="nyu40", **render):
    """A tiny scene config: the ScanNet template's keys at 3x32 and 27x36."""
    d = yaml.safe_load(open(SCANNET_CONFIG))
    d["experiment"].update(dataset_type=dstype, dataset_dir=str(data_dir), scene_name=SCENE,
                           nyu_mode=nyu_mode, save_dir=str(tmp_path / "run"), width=36,
                           height=27)
    d["model"] = {"netdepth": 3, "netwidth": 32, "chunk": 512, "netchunk": 512}
    d["render"].update(N_rays=16, N_samples=8, N_importance=8, multires=4, multires_views=2,
                       **render)
    d["train"]["N_iters"] = 4
    d["logging"] = {"step_log_print": 4, "step_log_tfb": 4, "step_save_ckpt": 4, "step_val": 100,
                    "step_vis_train": 100}
    path = tmp_path / "scene.yaml"
    path.write_text(yaml.dump(d))
    return str(path)


def _same_bundle(t, j, has_train_gt=True):
    pj, pt = j.pools, t.pools
    for name in ("rays", "rgb", "depth", "semantic", "mask_ids"):
        a, b = getattr(pt, name), getattr(pj, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0, err_msg=name)
    for name in ("rays_vis", "rays_test"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in ("h", "w", "h_scaled", "w_scaled", "num_valid_classes"):
        assert getattr(t, name) == getattr(j, name), name
    for gt_t, gt_j in ((t.test_gt, j.test_gt), (t.train_gt, j.train_gt)):
        assert sorted(gt_t) == sorted(gt_j)
        for k in gt_j:
            np.testing.assert_allclose(gt_t[k], gt_j[k], atol=1e-6, rtol=0, err_msg=k)
    assert bool(t.train_gt) == has_train_gt
    for name in ("colour_map", "semantic_class_ids"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert t.class_names == j.class_names


@pytest.mark.parametrize("in_place", [False, True], ids=["loader_resize", "in_place_resize"])
def test_prepare_scannet_bundle_matches_jax(room, tmp_path, in_place):
    path = _scene_cfg(tmp_path, room / "scan", "scannet")
    cj, ct = jconfig.from_yaml(path), tconfig.from_yaml(path)
    size = (None, None) if in_place else (27, 36)
    dj = jscan.load_scannet(str(room / "scan"), SCENE, img_h=size[0], img_w=size[1])
    dt = tscan.load_scannet(str(room / "scan"), SCENE, img_h=size[0], img_w=size[1])
    bj = jprep.prepare_scannet_bundle(cj, dj)
    bt = tprep.prepare_scannet_bundle(ct, dt, device="cpu")
    _same_bundle(bt, bj, has_train_gt=False)
    assert bt.colour_map is None and bt.pools.rays.shape == (3, 27 * 36, 11)


@pytest.mark.parametrize("mode", ["nyu13", "nyu34"])
def test_prepare_replica_bundle_nyu_branch_matches_jax(room, tmp_path, mode):
    path = _scene_cfg(tmp_path, room / "nyu", "replica_nyu_cnn", nyu_mode=mode)
    cj, ct = jconfig.from_yaml(path), tconfig.from_yaml(path)
    tr, te = jrep.default_replica_split(FRAMES, 4)
    args = (str(room / "nyu"), tr, te, mode, 27, 36)
    bj = jprep.prepare_replica_bundle(cj, jnyu.load_replica_nyu_cnn(*args))
    bt = tprep.prepare_replica_bundle(ct, tnyu.load_replica_nyu_cnn(*args), device="cpu")
    _same_bundle(bt, bj)
    assert len(bt.class_names) == (14 if mode == "nyu13" else 35)
    np.testing.assert_array_equal(bt.semantic_class_ids, np.arange(len(bt.class_names)))


# ---- the all-images sampler ----------------------------------------------


def _jax_all_images_draws(key, num_img, h, w, n):
    """The integer draws ``sample_ray_pairs_all_images`` makes from ``key``
    (its key splits, ``samplers.py:186-192``)."""
    k_img, k_pix, k_bh, k_bw = jax.random.split(key, 4)
    draws = (jax.random.randint(k_img, (n,), 0, num_img),
             jax.random.randint(k_pix, (n,), 0, h * w),
             jax.random.randint(k_bh, (n,), -1, 2), jax.random.randint(k_bw, (n,), -1, 2))
    return [torch.from_numpy(np.array(x, np.int64)) for x in draws]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_all_images_sampler_matches_jax(seed):
    rng = np.random.default_rng(30 + seed)
    n_img, h, w, n = 5, 6, 7, 64
    pools = dict(rays=rng.normal(size=(n_img, h * w, 11)).astype(np.float32),
                 rgb=rng.uniform(size=(n_img, h * w, 3)).astype(np.float32),
                 depth=rng.uniform(0.5, 5, size=(n_img, h * w)).astype(np.float32),
                 semantic=rng.integers(0, 6, size=(n_img, h * w)).astype(np.int64))
    pools["rays"][..., 0:3] = rng.normal(size=(n_img, 1, 3))  # one camera centre per image
    mask_ids = np.array([1, 0, 1, 0, 1], np.int64)
    key = jax.random.key(seed)
    bj = js.sample_ray_pairs_all_images(
        key, jnp.asarray(pools["rays"]), jnp.asarray(pools["rgb"]), h, w, n,
        depth_pool=jnp.asarray(pools["depth"]), sem_pool=jnp.asarray(pools["semantic"]),
        mask_ids=jnp.asarray(mask_ids))
    draws = _jax_all_images_draws(key, n_img, h, w, n)
    bt = ts.gather_ray_pairs_all_images(
        *(torch.from_numpy(pools[k]) for k in ("rays", "rgb")), h, w, *draws,
        depth_pool=torch.from_numpy(pools["depth"]), sem_pool=torch.from_numpy(pools["semantic"]),
        mask_ids=torch.from_numpy(mask_ids))
    for name in ("rays", "rgb", "depth"):
        np.testing.assert_allclose(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_array_equal(bt.semantic.numpy(), np.asarray(bj.semantic))
    assert float(bt.sem_flag) == float(bj.sem_flag) == 1.0
    assert int(bt.image_idx) == int(bj.image_idx)
    # rays of unsupervised images carry the void label; pairs share an image
    imgs = draws[0].numpy()
    assert len(np.unique(imgs)) > 1
    voided = np.concatenate([mask_ids[imgs] == 0] * 2)
    assert (bt.semantic.numpy()[voided] == 0).all()
    assert (bt.semantic.numpy()[~voided] > 0).any()
    np.testing.assert_array_equal(bt.rays[:n, 0:3].numpy(), bt.rays[n:, 0:3].numpy())


def test_all_images_sampler_draws_from_the_generator():
    rng = np.random.default_rng(33)
    n_img, h, w, n = 4, 5, 6, 32
    rays = torch.from_numpy(rng.normal(size=(n_img, h * w, 11)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(size=(n_img, h * w, 3)).astype(np.float32))
    a = ts.sample_ray_pairs_all_images(torch.Generator().manual_seed(4), rays, rgb, h, w, n)
    b = ts.sample_ray_pairs_all_images(torch.Generator().manual_seed(4), rays, rgb, h, w, n)
    draws = ts.draw_all_images_indices(torch.Generator().manual_seed(4), n_img, h, w, n)
    c = ts.gather_ray_pairs_all_images(rays, rgb, h, w, *draws)
    for x in (b, c):
        assert torch.equal(a.rays, x.rays) and torch.equal(a.rgb, x.rgb)
    assert a.depth is None and a.semantic is None and a.rays.shape == (2 * n, 11)


# ---- one step at the ScanNet config, C = 40 -------------------------------


def test_scannet_step_matches_jax():
    from test_torch_train import _step_case

    cj, ct = jconfig.from_yaml(SCANNET_CONFIG), tconfig.from_yaml(SCANNET_CONFIG)
    assert (ct.mlp.depth, ct.mlp.width, ct.mlp.skips, ct.mlp.use_viewdirs,
            ct.mlp.use_fused_kernel) == (8, 256, (4,), True, True)
    tkw = {f.name: getattr(ct.train, f.name) for f in dataclasses.fields(ct.train)
           if f.name != "n_rays"}
    assert tkw == {k: getattr(cj.train, k) for k in tkw}
    rep_j, rep_t, grads = _step_case(
        dataclasses.replace(cj.mlp, num_semantic_classes=40),
        dataclasses.replace(ct.mlp, num_semantic_classes=40),
        dict(n_coarse=16, n_importance=16), tkw, n_pairs=16, classes=40, semantic_mask=False,
        seed=40)
    for name in rep_j._fields:
        a, b = float(getattr(rep_j, name)), float(getattr(rep_t, name))
        assert np.isfinite(b) and abs(a - b) <= 1e-3 * max(abs(a), 1e-6), (name, a, b)
    assert float(rep_t.semantic) > 0
    for got, ref in grads:
        cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos > 0.999, cos


# ---- the CLI ------------------------------------------------------------


def _latest_ckpt(save_dir):
    ckpts = sorted((save_dir / "checkpoints").glob("*.ckpt"))
    assert ckpts, "no checkpoint written"
    return ckpts[-1]


@pytest.mark.parametrize("case", ["scannet_pixel_denoising", "scannet_all_images",
                                  "replica_nyu_sparse_views", "replica_region_denoising"])
def test_scene_cli_on_the_other_data(room, tmp_path, case, capsys):
    """Four steps of the port's scene CLI on the CPU; the checkpoint loads
    through the JAX package's importer to the trained parameters."""
    render, flags = {}, []
    if case.startswith("scannet"):
        path = _scene_cfg(tmp_path, room / "scan", "scannet", "nyu34",
                          **({"no_batching": False} if case == "scannet_all_images" else {}))
        if case == "scannet_pixel_denoising":
            flags = ["--pixel_denoising", "--pixel_noise_ratio", "0.3"]
    elif case == "replica_nyu_sparse_views":
        path = _scene_cfg(tmp_path, room / "nyu", "replica_nyu_cnn", "nyu13")
        flags = ["--sparse_views", "--sparse_ratio", "0.5", "--total_frames", str(FRAMES),
                 "--split_step", "4"]
    else:
        path = _scene_cfg(tmp_path, room / "replica", "replica")
        flags = ["--region_denoising", "--total_frames", str(FRAMES), "--split_step", "4"]
    train_scene.main(["--config_file", path, "--device", "cpu", "--no_progress", *flags])
    out = capsys.readouterr().out
    assert "training complete" in out
    assert ("sampling pixels across all training images" in out) == (case == "scannet_all_images")
    step, sd_c, sd_f = jimport.load_reference_checkpoint(str(_latest_ckpt(tmp_path / "run")))
    assert step == 4
    cfg = tconfig.from_yaml(path)
    args = train_scene.parse_args(["--config_file", path, *flags])
    bundle = train_scene.prepare_bundle(cfg, train_scene.build_dataset(cfg, args), "cpu")
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    with Trainer(cfg, bundle, device="cpu") as t:
        assert t.maybe_resume() == 4
        for sd, m in ((sd_c, t.state.model_coarse), (sd_f, t.state.model_fine)):
            got = jax.tree_util.tree_leaves(jimport.state_dict_to_params(sd))
            ref = jax.tree_util.tree_leaves(params_to_jax(m))
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_dataset_applies_the_flags_in_the_jax_order(room, tmp_path):
    path = _scene_cfg(tmp_path, room / "replica", "replica")
    flags = ["--total_frames", str(FRAMES), "--split_step", "4", "--sparse_views",
             "--sparse_ratio", "0.5", "--random_sample", "--pixel_denoising",
             "--pixel_noise_ratio", "0.2", "--super_resolution", "--dense_sr", "2"]
    ns = train_scene.parse_args(["--config_file", path, *flags])
    t = train_scene.build_dataset(tconfig.from_yaml(path), ns)
    import train_scene as jtrain_scene

    j = jtrain_scene.build_dataset(jconfig.from_yaml(path), ns)
    np.testing.assert_array_equal(t.mask_ids, j.mask_ids)
    np.testing.assert_array_equal(t.train_samples["semantic_remap"],
                                  j.train_samples["semantic_remap"])


def test_region_denoising_without_instance_maps_exits(room, tmp_path):
    path = _scene_cfg(tmp_path, room / "scan", "scannet")
    with pytest.raises(SystemExit, match="semantic_instance"):
        train_scene.main(["--config_file", path, "--device", "cpu", "--region_denoising"])


def test_scannet_bundle_and_clis_default_to_cuda_and_raise(room, tmp_path, monkeypatch):
    """Without a GPU, the ScanNet bundle, the scene CLI and the mesh CLI
    raise unless the caller asks for the CPU."""
    from intrinsicnerf_tpu_torch import extract_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _scene_cfg(tmp_path, room / "scan", "scannet")
    data = tscan.load_scannet(str(room / "scan"), SCENE, img_h=27, img_w=36)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprep.prepare_scannet_bundle(tconfig.from_yaml(path), data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_scene.main(["--config_file", path, "--no_progress"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_mesh.main(["--config_file", path])
