"""The object pipeline's data side of the PyTorch port against the JAX
package (CPU): loaders, the pose sampler, the bundle, the cube ray
tracer and the video writer.

Fixture directories are built as ``tests/test_data.py`` builds them.
Tolerances:

- loaders: images and masks equal exactly (the same 8-bit PNGs, decoded
  by OpenCV in the port and by ``imageio`` in the JAX package; the
  ``half_res`` resize is the same ``cv2.INTER_AREA`` call), poses and
  focal within 1e-6;
- the pose sampler: the JAX key splits reproduced here, their integer
  draws fed to the port's gather; rays, rgb and mask within 1e-6 of the
  JAX sampler's (the same fp32 arithmetic, a matmul's sum order apart);
- the bundle and the cube ray tracer: within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicnerf_tpu.config import from_object_txt as j_from_object_txt
from intrinsicnerf_tpu.data import blender as jb
from intrinsicnerf_tpu.data import deepvoxels as jdv
from intrinsicnerf_tpu.data import llff as jllff
from intrinsicnerf_tpu.data import samplers as js
from intrinsicnerf_tpu.train import prepare as jprep
from intrinsicnerf_tpu_torch.config import from_object_txt
from intrinsicnerf_tpu_torch.data import blender as tb
from intrinsicnerf_tpu_torch.data import deepvoxels as tdv
from intrinsicnerf_tpu_torch.data import llff as tllff
from intrinsicnerf_tpu_torch.data import samplers as ts
from intrinsicnerf_tpu_torch.train import prepare as tprep
from intrinsicnerf_tpu_torch.utils.image import imwrite


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imwrite(path, arr)


def _same_data(j, t):
    np.testing.assert_array_equal(t.images, j.images)
    assert t.images.dtype == j.images.dtype == np.float32
    np.testing.assert_allclose(t.poses, j.poses, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.render_poses, j.render_poses, atol=1e-6, rtol=0)
    assert (t.h, t.w) == (j.h, j.w)
    assert abs(t.focal - j.focal) <= 1e-6 * max(1.0, abs(j.focal))
    for a, b in zip(t.i_split, j.i_split):
        np.testing.assert_array_equal(a, b)


# ---- Blender and Blender-intrinsic --------------------------------------


def _blender_dir(root, h, w, channels=4, counts=(("train", 3), ("val", 2), ("test", 2)),
                 intrinsic=False, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in counts:
        frames = []
        for i in range(n):
            name = f"r_{i}"
            img = rng.integers(0, 255, size=(h, w, channels)).astype(np.uint8)
            if intrinsic:
                _png(os.path.join(root, split, "color", f"{name}.png"), img)
                _png(os.path.join(root, split, "albedo", f"{name}_albedo_0001.png"),
                     np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1))
            else:
                _png(os.path.join(root, split, f"{name}.png"), img)
            pose = np.eye(4)
            pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            pose[:3, 3] = rng.normal(size=3) * 2 + [0, 0, 4.0 + i]
            frames.append({"file_path": f"./{split}/{name}", "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return str(root)


@pytest.mark.parametrize("h,w,channels,half_res,testskip", [
    (8, 8, 4, False, 1), (16, 12, 4, True, 1), (9, 11, 4, True, 2), (8, 8, 3, False, 1)],
    ids=["8x8", "half_res", "half_res_odd_testskip", "rgb_files"])
def test_load_blender_matches_jax(tmp_path, h, w, channels, half_res, testskip):
    d = _blender_dir(tmp_path, h, w, channels)
    j = jb.load_blender_data(d, half_res=half_res, testskip=testskip)
    t = tb.load_blender_data(d, half_res=half_res, testskip=testskip)
    _same_data(j, t)
    assert t.images.shape[-1] == channels and t.render_poses.shape == (40, 4, 4)
    assert [len(s) for s in t.i_split] == [3, 2 // testskip, 2 // testskip]
    if half_res:
        assert (t.h, t.w) == (h // 2, w // 2)
        np.testing.assert_allclose(t.focal, 0.25 * w / np.tan(0.5 * 0.6911), rtol=1e-6)


@pytest.mark.parametrize("half_res", [False, True])
def test_load_blender_intrinsic_matches_jax(tmp_path, half_res):
    d = _blender_dir(tmp_path, 12, 12, intrinsic=True,
                     counts=(("train", 2), ("val", 1), ("test", 1)))
    j = jb.load_blender_intrinsic_data(d, half_res=half_res)
    t = tb.load_blender_intrinsic_data(d, half_res=half_res)
    _same_data(j, t)
    np.testing.assert_array_equal(t.albedo_images, j.albedo_images)
    assert t.render_poses.shape == (80, 4, 4)
    # the albedo companions are the colour files with R and B swapped
    np.testing.assert_array_equal(t.albedo_images[..., :3], t.images[..., 2::-1])


def test_pose_helpers_and_composite_match_jax():
    for th, phi, r in ((0.0, -30.0, 4.0), (45.0, -10.0, 3.0), (-120.0, -65.0, 4.5)):
        np.testing.assert_allclose(tb.pose_spherical(th, phi, r), jb.pose_spherical(th, phi, r),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tb.spherical_render_poses(8), jb.spherical_render_poses(8))
    rgba = np.random.default_rng(1).uniform(size=(2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(tb.composite_white_background(rgba),
                                  jb.composite_white_background(rgba))


# ---- LLFF ------------------------------------------------------------------


def _llff_dir(root, n=9, h=6, w=8, inward=False, seed=0):
    """``poses_bounds.npy`` in LLFF's [down right back] columns and
    ``images_8/``: cameras on a forward-facing arc, or around a centre."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if inward:
            # an arc of 120 degrees: the mean view direction stays well defined
            c2w = jb.pose_spherical(15.0 * i, -20.0 - 5 * (i % 3), 4.0).astype(np.float64)
        else:
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(np.eye(3) + 0.05 * rng.normal(size=(3, 3)))[0]
            c2w[:3, :3] *= np.sign(np.diag(c2w[:3, :3]))
            c2w[:3, 3] = [0.3 * np.cos(i), 0.2 * np.sin(i), 0.1 * rng.normal()]
        r, u, b, t = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3]
        pose = np.stack([-u, r, b, t, [h * 8, w * 8, 40.0]], axis=1)  # [3, 5]
        rows.append(np.concatenate([pose.ravel(), [2.0 + 0.1 * i, 9.0 + i]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    for i in range(n):
        _png(os.path.join(root, "images_8", f"img_{i:03d}.png"),
             rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
    return str(root)


def _same_llff(j, t, full_w):
    """The port's LLFF data against the JAX loader's: images exactly,
    poses, render poses and bounds within 1e-6, but for the focal.  The JAX
    loader writes the image size into a view of ``poses_bounds.npy`` and
    then scales the focal by the overwritten width, so images read from a
    shrunk ``images_{factor}`` keep the full-size focal; the port scales it
    by ``w / full_w``, as the original loader does."""
    np.testing.assert_array_equal(t.images, j.images)
    for name in ("poses", "render_poses"):
        np.testing.assert_allclose(getattr(t, name)[..., :4], getattr(j, name)[..., :4],
                                   atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(t.bds, j.bds, atol=1e-6, rtol=0)
    assert (t.h, t.w, t.i_test) == (j.h, j.w, j.i_test)
    scale = t.w / full_w
    assert abs(t.focal - j.focal * scale) <= 1e-6 * t.focal
    np.testing.assert_allclose(t.poses[:, 2, 4], j.poses[:, 2, 4] * scale, rtol=1e-6)
    np.testing.assert_array_equal(t.poses[:, :2, 4], j.poses[:, :2, 4])


@pytest.mark.parametrize("spherify", [False, True], ids=["recenter_spiral", "spherify"])
def test_load_llff_matches_jax(tmp_path, spherify):
    d = _llff_dir(tmp_path, inward=spherify)
    j = jllff.load_llff_data(d, factor=8, spherify=spherify)
    t = tllff.load_llff_data(d, factor=8, spherify=spherify)
    _same_llff(j, t, full_w=8 * 8)
    assert (t.h, t.w) == (6, 8) and t.focal == pytest.approx(40.0 / 8)
    assert t.render_poses.shape == (120, 3, 5)
    np.testing.assert_allclose(tllff.recenter_poses(t.poses), jllff.recenter_poses(t.poses),
                               atol=1e-6)


def test_llff_from_blender_frames_matches_jax(tmp_path):
    """The LLFF capture ``chip_smoke.py`` trains on in NDC is written from
    Blender frames by ``write_llff_from_blender``; both loaders read it
    alike, at the full-size focal scaled to the shrunk images."""
    from intrinsicnerf_tpu_torch.tools.synthetic_blender import write_llff_from_blender

    src = _blender_dir(tmp_path / "blender", 16, 16, counts=(("train", 6), ("val", 1),
                                                             ("test", 1)))
    d = str(tmp_path / "llff")
    assert write_llff_from_blender(src, d, views=range(5), factor=2) == 5
    j = jllff.load_llff_data(d, factor=2)
    t = tllff.load_llff_data(d, factor=2)
    _same_llff(j, t, full_w=16)
    assert t.images.shape == (5, 8, 8, 3) and (t.h, t.w) == (8, 8)
    np.testing.assert_allclose(t.focal, 0.5 * 8 / np.tan(0.5 * 0.6911), rtol=1e-5)


# ---- DeepVoxels and LINEMOD --------------------------------------------------


def test_dv_intrinsics_match_jax(tmp_path):
    f = tmp_path / "intrinsics.txt"
    f.write_text("525.0 256.0 240.0\n0 0 0\n0.8\n1.0\n512 480\n0\n")
    for side in (512, 256):
        assert tdv.parse_dv_intrinsics(str(f), side) == jdv.parse_dv_intrinsics(str(f), side)


def test_load_dv_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for split, n in (("train", 3), ("validation", 4), ("test", 4)):
        base = tmp_path / split / "cube"
        (base / "pose").mkdir(parents=True)
        (base / "intrinsics.txt").write_text("525.0 256.0 256.0\n0 0 0\n0.8\n1.0\n512 512\n0\n")
        for i in range(n):
            np.savetxt(str(base / "pose" / f"{i:05d}.txt"),
                       np.eye(4).ravel()[None] + rng.normal(size=(1, 16)) * 0.1)
            _png(str(base / "rgb" / f"{i:05d}.png"),
                 rng.integers(0, 255, size=(8, 8, 3)).astype(np.uint8))
    j = jdv.load_dv_data("cube", str(tmp_path), testskip=2)
    t = tdv.load_dv_data("cube", str(tmp_path), testskip=2)
    _same_data(j, t)
    assert (t.near, t.h) == (j.near, 512) and [len(s) for s in t.i_split] == [3, 2, 2]


@pytest.mark.parametrize("channels", [3, 4])
def test_load_linemod_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(4)
    for split, n in (("train", 2), ("val", 1), ("test", 2)):
        frames = []
        for i in range(n):
            name = f"{split}_{i}.png"
            _png(str(tmp_path / "frames" / name),
                 rng.integers(0, 255, size=(8, 10, channels)).astype(np.uint8))
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(size=3)
            frames.append({"file_path": f"frames/{name}", "transform_matrix": pose.tolist(),
                           "intrinsic_matrix": [[50.0, 0, 5], [0, 50.0, 4], [0, 0, 1]]})
        (tmp_path / f"transforms_{split}.json").write_text(json.dumps({"frames": frames}))
    for half_res in (False, True):
        j = jdv.load_linemod_data(str(tmp_path), half_res=half_res)
        t = tdv.load_linemod_data(str(tmp_path), half_res=half_res)
        _same_data(j, t)
        assert t.images.shape[-1] == 4  # alpha synthesized for 3-channel files


# ---- the pose sampler --------------------------------------------------------

PH, PW, PN = 9, 12, 50  # an odd height: crop = 1.0 never draws the last row


def _pose_pools(seed=5, n_img=3, forward=False):
    """Pools of ``n_img`` views: around the object, or (``forward``)
    facing -z from near the origin, as an LLFF capture in NDC does."""
    rng = np.random.default_rng(seed)
    if forward:
        poses = np.tile(np.eye(4), (n_img, 1, 1))
        poses[:, :3, 3] = rng.normal(size=(n_img, 3)) * 0.1
    else:
        poses = np.stack([jb.pose_spherical(40.0 * i, -30.0, 4.0) for i in range(n_img)])
    dirs = np.asarray(jprep.camera_ray_dirs(PH, PW, 10.0, 10.0, PW * 0.5, PH * 0.5,
                                            convention="opengl")).reshape(-1, 3)
    rgb = rng.uniform(size=(n_img, PH * PW, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n_img, PH * PW)) > 0.4).astype(np.float32)
    return dirs, poses.astype(np.float32), rgb, mask


def _jax_pose_draws(key, num_img, crop):
    """The integer draws of the JAX ``sample_ray_pairs_from_poses`` at
    ``key`` (its key splits, ``samplers.py:121-131``)."""
    k_img, k_h, k_w, k_bh, k_bw = jax.random.split(key, 5)
    img = jax.random.randint(k_img, (), 0, num_img)
    if crop is not None:
        dh = max(int(np.float32(PH // 2) * np.float32(crop)), 1)
        dw = max(int(np.float32(PW // 2) * np.float32(crop)), 1)
        idx_h = PH // 2 - dh + jax.random.randint(k_h, (PN,), 0, 2 * dh)
        idx_w = PW // 2 - dw + jax.random.randint(k_w, (PN,), 0, 2 * dw)
    else:
        idx_h = jax.random.randint(k_h, (PN,), 0, PH)
        idx_w = jax.random.randint(k_w, (PN,), 0, PW)
    bh = jax.random.randint(k_bh, (PN,), -1, 2)
    bw = jax.random.randint(k_bw, (PN,), -1, 2)
    return [torch.from_numpy(np.array(x, np.int64)) for x in (img, idx_h, idx_w, bh, bw)]


@pytest.mark.parametrize("crop,ndc", [(None, False), (0.5, False), (1.0, False), (None, True),
                                      (0.5, True)],
                         ids=["full_frame", "precrop", "crop_1_odd_h", "ndc", "ndc_precrop"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pose_sampler_same_draws_same_batch(crop, ndc, seed):
    dirs, poses, rgb, mask = _pose_pools(forward=ndc)
    key = jax.random.key(seed)
    ndc_focal = 10.0 if ndc else None
    bj = js.sample_ray_pairs_from_poses(
        key, jnp.asarray(dirs), jnp.asarray(poses), jnp.asarray(rgb), PH, PW, PN, 2.0, 6.0,
        mask_pool=jnp.asarray(mask), crop_frac=None if crop is None else jnp.float32(crop),
        ndc_focal=ndc_focal)
    draws = _jax_pose_draws(key, len(poses), crop)
    bt = ts.gather_ray_pairs_from_poses(torch.from_numpy(dirs), torch.from_numpy(poses),
                                        torch.from_numpy(rgb), PH, PW, *draws, 2.0, 6.0,
                                        mask_pool=torch.from_numpy(mask), ndc_focal=ndc_focal)
    for name in ("rays", "rgb", "semantic"):
        np.testing.assert_allclose(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert float(bt.sem_flag) == float(bj.sem_flag) == 0.0 and bt.depth is None
    assert int(bt.image_idx) == int(bj.image_idx)
    if ndc:  # near, far 0, 1; the view directions in world space
        np.testing.assert_array_equal(bt.rays[:, 6:8].numpy(), np.tile([0.0, 1.0], (2 * PN, 1)))
        d = bt.rays[:, 8:11].numpy()
        np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)


def test_pose_sampler_crop_follows_the_device_step():
    """Before ``precrop_iters`` the rows lie in the centre crop; after it
    they come from the crop of fraction 1.0, which at an odd height never
    reaches the last row (as in the JAX sampler); without precrop every
    row is drawn.  Each call draws the same amount from the generator."""
    n = 4000
    rows = {}
    for name, step, iters in (("in", 3, 5), ("after", 5, 5), ("off", 0, 0)):
        g = torch.Generator().manual_seed(0)
        img, h, w, bh, bw = ts.draw_pose_pair_indices(g, 3, PH, PW, n, torch.tensor(step), iters,
                                                      0.5)
        rows[name] = (h, w, g.get_state())
        assert img.shape == () and h.shape == w.shape == bh.shape == bw.shape == (n,)
        assert set(bh.tolist()) == set(bw.tolist()) == {-1, 0, 1}
    h, w, _ = rows["in"]
    dh, dw = max(int(PH // 2 * 0.5), 1), max(int(PW // 2 * 0.5), 1)
    assert h.min() == PH // 2 - dh and h.max() == PH // 2 + dh - 1
    assert w.min() == PW // 2 - dw and w.max() == PW // 2 + dw - 1
    h, w, _ = rows["after"]
    assert h.min() == 0 and h.max() == PH - 2 and w.min() == 0 and w.max() == PW - 1
    h, w, _ = rows["off"]
    assert h.min() == 0 and h.max() == PH - 1
    assert torch.equal(rows["in"][2], rows["after"][2])


# ---- the bundle --------------------------------------------------------------


def _txt(path, datadir, **kw):
    lines = {"expname": "obj", "basedir": str(path), "datadir": datadir,
             "dataset_type": "blender", "white_bkgd": True, "N_rand": 16, **kw}
    p = os.path.join(str(path), "cfg.txt")
    with open(p, "w") as f:
        f.write("\n".join(f"{k} = {v}" for k, v in lines.items()))
    return p


def _same_bundle(bj, pj, bt, pt, atol=1e-6, rtol=0.0):
    assert pt is bt.pools and bt.rays_cluster is bt.rays_test
    for name in ("dirs_cam", "poses", "rgb", "mask"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in ("rays_test", "rays_vis"):
        np.testing.assert_allclose(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)),
                                   atol=atol, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(bt.test_gt["image"], bj.test_gt["image"], atol=1e-6, rtol=0)
    assert (bt.h, bt.w, bt.h_scaled, bt.w_scaled, bt.num_valid_classes) == (
        bj.h, bj.w, bj.h_scaled, bj.w_scaled, bj.num_valid_classes)


@pytest.mark.parametrize("white_bkgd", [True, False], ids=["white", "black"])
def test_prepare_blender_bundle_matches_jax(tmp_path, white_bkgd):
    d = _blender_dir(tmp_path / "data", 8, 10)
    cfg_path = _txt(tmp_path, d, white_bkgd=white_bkgd)
    bj, pj = jprep.prepare_blender_bundle(j_from_object_txt(cfg_path), jb.load_blender_data(d))
    bt, pt = tprep.prepare_blender_bundle(from_object_txt(cfg_path), tb.load_blender_data(d),
                                          device="cpu")
    _same_bundle(bj, pj, bt, pt)
    assert (bt.h, bt.w, bt.num_valid_classes) == (8, 10, 0)
    assert bt.rays_vis.shape == (40, 80, 11) and bt.rays_test.shape == (2, 80, 11)


@pytest.mark.parametrize("ndc", [True, False], ids=["ndc", "no_ndc"])
def test_llff_bundle_matches_jax(tmp_path, ndc):
    """The CLI's LLFF path: the every-``llffhold``-th view held out, the
    depth range from the bounds (or [0, 1] in NDC), the test and path
    rays projected to NDC.  NDC magnifies by 1/z, so its rays are held
    within 1e-6 relative as well."""
    import train_object as jcli

    from intrinsicnerf_tpu_torch import train_object as tcli

    d = _llff_dir(tmp_path / "data")
    cfg_path = _txt(tmp_path, d, dataset_type="llff", llffhold=3, factor=8,
                    **({} if ndc else {"no_ndc": True}))
    cfg_j, cfg_t = j_from_object_txt(cfg_path), from_object_txt(cfg_path)
    dj, dt = jcli._llff_as_blender(cfg_j), tcli.load_object_data(cfg_t)
    # the focal apart (see _same_llff), the same data
    np.testing.assert_allclose(dt.focal, dj.focal / 8, rtol=1e-6)
    dj.focal = dt.focal
    _same_data(dj, dt)
    assert cfg_t.depth_range == cfg_j.depth_range
    assert cfg_t.depth_range == (0.0, 1.0) if ndc else cfg_t.depth_range[0] > 0
    focal = tcli.ndc_focal_for(cfg_t, dt)
    assert (focal == dt.focal) if ndc else focal is None
    bj, pj = jprep.prepare_blender_bundle(cfg_j, dj, ndc_focal=focal)
    bt, pt = tprep.prepare_blender_bundle(cfg_t, dt, ndc_focal=focal, device="cpu")
    _same_bundle(bj, pj, bt, pt, rtol=1e-6)
    assert [len(s) for s in dt.i_split] == [6, 3, 3]


def test_apply_ndc_to_rays_matches_jax():
    rays = np.random.default_rng(6).normal(size=(3, 7, 11)).astype(np.float32)
    rays[..., 5] = -np.abs(rays[..., 5]) - 0.5  # forward-facing: -z
    rays[..., 2] = -np.abs(rays[..., 2]) - 1.0
    np.testing.assert_allclose(tprep.apply_ndc_to_rays(torch.from_numpy(rays), 6, 8, 7.0).numpy(),
                               np.asarray(jprep.apply_ndc_to_rays(jnp.asarray(rays), 6, 8, 7.0)),
                               atol=1e-6, rtol=1e-6)


# ---- the cube of the convergence check, and the video writer ------------------


def test_cube_raytracer_matches_jax_tool():
    import tools_validate_convergence as jtool

    from intrinsicnerf_tpu_torch.tools import validate_convergence as tool

    imgs_j, poses_j = jtool.raytrace_cube_views(5, 16)
    imgs_t, poses_t = tool.raytrace_cube_views(5, 16)
    np.testing.assert_allclose(poses_t, poses_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(imgs_t, imgs_j, atol=1e-6, rtol=0)
    assert imgs_t.shape == (5, 16, 16, 4) and 0 < imgs_t[..., 3].mean() < 1


def test_cube_check_runs_on_the_cpu(tmp_path, capsys):
    """The cube check trains on the CPU through the plain versions (no
    fallback message) and reports a finite held-out PSNR."""
    from intrinsicnerf_tpu_torch.tools import validate_convergence as tool

    result = tool.run(steps=4, res=8, views=6, n_coarse=4, n_importance=4, device="cpu",
                      save_dir=str(tmp_path))
    assert "falling back" not in capsys.readouterr().out
    assert result["steps"] == 4 and np.isfinite(result["psnr"]) and not result["fused"]


def test_video_from_pngs_reads_back(tmp_path):
    import cv2

    from intrinsicnerf_tpu_torch.tools import video

    rng = np.random.default_rng(7)
    for i in range(6):
        imwrite(str(tmp_path / f"rgb_{i:03d}.png"), rng.integers(0, 255, (32, 48, 3), np.uint8))
        imwrite(str(tmp_path / f"c{i:03d}.png"), rng.integers(0, 255, (32, 48, 3), np.uint8))
    imwrite(str(tmp_path / "depth_000.png"), rng.integers(0, 9000, (32, 48), np.uint16))
    written = video.generate_all(str(tmp_path))
    assert [os.path.basename(p) for p in written] == ["rgb.mp4", "c.mp4"]
    for path in written:
        cap = cv2.VideoCapture(path)
        frames = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            assert frame.shape == (32, 48, 3)
            frames += 1
        cap.release()
        assert frames == 6, path
    assert video.frames_matching(str(tmp_path), "rgb")[0].endswith("rgb_000.png")
    with pytest.raises(FileNotFoundError):
        video.pngs_to_video(str(tmp_path), "albedo", str(tmp_path / "a.mp4"))
