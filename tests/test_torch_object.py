"""The object pipeline's training side of the PyTorch port against the
JAX package (CPU): one object training step, the step counter the
sampler reads, and the ``train_object`` CLI twin.

Tolerances, those of ``tests/test_torch_train.py``:

- one whole object step from identical weights and the same batch (the
  JAX pose sampler's batch, and the port's gather of the same integer
  draws), perturb 0 and no sigma noise, so neither side draws:
  - fused at width 256 with the semantic head off (JAX: Pallas in
    interpret mode; port: the kernels' plain versions): loss terms within
    1e-3 relative, per-level gradient cosine > 0.999;
  - unfused at width 32 in fp32: loss terms atol 1e-5, gradients rtol
    1e-4 with an absolute floor of 1e-4 times the level's largest
    gradient;
- the step counter: ``make_multi_step(step, 4)`` and four single steps
  give bitwise-equal batches, the sampler is handed the device counter,
  and the precrop warm-up ends at ``precrop_iters`` inside the block.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicnerf_tpu.cluster import assign as ja
from intrinsicnerf_tpu.data import samplers as js
from intrinsicnerf_tpu.data.blender import pose_spherical
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu.tools import import_ckpt as jimport
from intrinsicnerf_tpu.train import prepare as jprep
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu_torch import train_object as cli
from intrinsicnerf_tpu_torch.cluster import assign as ta
from intrinsicnerf_tpu_torch.data import samplers as ts
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.train import step as tstep
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, make_object_sample_fn
from intrinsicnerf_tpu_torch.utils.image import imwrite
from test_torch_train import _capture, _level_grads, _lift_sigma, _load_jax

H, W = 10, 12


def _pools(rng, n_img=3):
    poses = np.stack([pose_spherical(50.0 * i, -30.0, 4.0) for i in range(n_img)])
    dirs = np.asarray(jprep.camera_ray_dirs(H, W, 9.0, 9.0, W * 0.5, H * 0.5,
                                            convention="opengl")).reshape(-1, 3)
    rgb = rng.uniform(0.05, 0.95, size=(n_img, H * W, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n_img, H * W)) > 0.3).astype(np.float32)
    return dirs, poses.astype(np.float32), rgb, mask


def _batches(rng, n_pairs, key):
    """The JAX pose sampler's batch at ``key`` (precrop on), and the port's
    gather of the same integer draws."""
    dirs, poses, rgb, mask = _pools(rng)
    bj = js.sample_ray_pairs_from_poses(key, jnp.asarray(dirs), jnp.asarray(poses),
                                        jnp.asarray(rgb), H, W, n_pairs, 2.0, 6.0,
                                        mask_pool=jnp.asarray(mask), crop_frac=jnp.float32(0.5))
    k_img, k_h, k_w, k_bh, k_bw = jax.random.split(key, 5)
    dh, dw = max(int(H // 2 * 0.5), 1), max(int(W // 2 * 0.5), 1)
    draws = (jax.random.randint(k_img, (), 0, len(poses)),
             H // 2 - dh + jax.random.randint(k_h, (n_pairs,), 0, 2 * dh),
             W // 2 - dw + jax.random.randint(k_w, (n_pairs,), 0, 2 * dw),
             jax.random.randint(k_bh, (n_pairs,), -1, 2), jax.random.randint(k_bw, (n_pairs,), -1, 2))
    draws = [torch.from_numpy(np.array(x, np.int64)) for x in draws]
    bt = ts.gather_ray_pairs_from_poses(*(torch.from_numpy(a) for a in (dirs, poses, rgb)), H, W,
                                        *draws, 2.0, 6.0, mask_pool=torch.from_numpy(mask))
    np.testing.assert_allclose(bt.rays.numpy(), np.asarray(bj.rays), atol=1e-6, rtol=0)
    return bj, bt


def _one_table(rng):
    k, m = 5, 32
    centers = rng.uniform(0.05, 1.0, size=(k, 3)).astype(np.float32)
    links = rng.integers(0, k, size=m)
    anchors = np.asarray(ja.map_drgb(jnp.asarray(centers[links]))) + rng.normal(
        size=(m, 3)).astype(np.float32) * 0.02
    per = [(anchors, links, centers)]  # objects: one class
    return ja.table_from_numpy(per, m), ta.table_from_numpy(per, m, device="cpu")


def _object_step(jcfg, tcfg_m, n_pairs, n_samples, seed):
    """Loss reports and per-level (port, JAX) gradients of one object step."""
    rng = np.random.default_rng(seed)
    rkw = dict(n_coarse=n_samples, n_importance=n_samples, perturb=0.0, raw_noise_std=0.0,
               white_bkgd=True)
    tkw = dict(n_rays=n_pairs, mask_mode="mask", no_semantic_tree=True)
    tj, tt = jstep.TrainConfig(**tkw), tstep.TrainConfig(**tkw)
    jbatch, tbatch = _batches(rng, n_pairs, jax.random.key(seed))
    table_j, table_t = _one_table(rng)

    opt = _capture()
    state_j = jstep.create_train_state(jax.random.key(seed), jcfg, tj, opt)
    state_j = state_j._replace(params_coarse=_lift_sigma(state_j.params_coarse),
                               params_fine=_lift_sigma(state_j.params_fine))
    step_j = jax.jit(jstep.make_train_step(jcfg, jp.RenderConfig(**rkw), tj, opt, H, W,
                                           sample_fn=lambda k, p, s: jbatch))
    new_j, rep_j = step_j(state_j, None, table_j, jnp.float32(0.5), jax.random.key(1))

    state_t = tstep.create_train_state(tcfg_m, tt, device="cpu")
    for model, pj in ((state_t.model_coarse, state_j.params_coarse),
                      (state_t.model_fine, state_j.params_fine)):
        _load_jax(model, pj, jcfg)
    step_t = tstep.make_train_step(tcfg_m, tp.RenderConfig(**rkw), tt, H, W,
                                   sample_fn=lambda g, p, s: tbatch)
    rep_t = step_t(state_t, None, table_t, 0.5, torch.Generator().manual_seed(0))

    grads = []
    for model, gj in ((state_t.model_coarse, new_j.opt_state["coarse"]),
                      (state_t.model_fine, new_j.opt_state["fine"])):
        got, ref, named = _level_grads(model, gj, jcfg)
        assert not any("semantic" in k for k in named)  # the head is off
        assert all(named[k].abs().max() > 0 for k in named), "a parameter got no gradient"
        grads.append((got, ref))
    assert float(rep_t.semantic) == 0.0 and float(rep_t.reflect_cluster) > 0
    return rep_j, rep_t, grads


def test_object_step_fused_matches_jax():
    kw = dict(pos_scalar_factor=1.0, enable_semantic=False, num_semantic_classes=0,
              use_fused_kernel=True)
    rep_j, rep_t, grads = _object_step(jm.MLPConfig(compute_dtype=jnp.bfloat16, **kw),
                                       tm.MLPConfig(compute_dtype=torch.bfloat16, **kw),
                                       n_pairs=16, n_samples=16, seed=40)
    assert rep_t._fields == rep_j._fields
    for name in rep_j._fields:
        a, b = float(getattr(rep_j, name)), float(getattr(rep_t, name))
        assert np.isfinite(b) and abs(a - b) <= 1e-3 * max(abs(a), 1e-6), (name, a, b)
    for got, ref in grads:  # coarse, fine
        cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos > 0.999, cos


def test_object_step_unfused_fp32_matches_jax():
    kw = dict(depth=4, width=32, skips=(2,), n_freqs_pos=6, n_freqs_dir=3, pos_scalar_factor=1.0,
              enable_semantic=False, num_semantic_classes=0)
    rep_j, rep_t, grads = _object_step(jm.MLPConfig(**kw), tm.MLPConfig(**kw), n_pairs=12,
                                       n_samples=12, seed=41)
    for name in rep_j._fields:
        np.testing.assert_allclose(float(getattr(rep_t, name)), float(getattr(rep_j, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    for got, ref in grads:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


# ---- the step counter the sampler reads ---------------------------------------


def test_multi_step_sampler_sees_the_device_counter():
    """Through ``make_multi_step(step, 4)`` the object sampler gives the
    batches of four single steps, bitwise: it is handed the device
    counter ``state.step_t``, so the precrop warm-up (2 steps here) ends
    inside the block, where the single steps end it."""
    rng = np.random.default_rng(42)
    dirs, poses, rgb, mask = _pools(rng)
    pools = tstep.PosePools(*(torch.from_numpy(a) for a in (dirs, poses, rgb, mask)))
    mcfg = tm.MLPConfig(depth=2, width=16, skips=(), n_freqs_pos=2, n_freqs_dir=1,
                        enable_semantic=False)
    tcfg = tstep.TrainConfig(n_rays=64, mask_mode="mask")
    cfg = type("Cfg", (), dict(depth_range=(2.0, 6.0), train=tcfg, precrop_iters=2,
                               precrop_frac=0.5))()
    bundle = SceneBundle(pools=pools, rays_vis=None, rays_test=None, h=H, w=W, h_scaled=H,
                         w_scaled=W, num_valid_classes=0)
    sampler = make_object_sample_fn(cfg, bundle)
    rcfg = tp.RenderConfig(n_coarse=4, n_importance=0, perturb=1.0)
    table = ta.empty_cluster_table(1, 8, device="cpu")
    runs = []
    for k in (1, 4):
        seen = []

        def sample_fn(generator, pools_, step):
            assert torch.is_tensor(step) and step is state.step_t
            seen.append((int(step), sampler(generator, pools_, step)))
            return seen[-1][1]

        state = tstep.create_train_state(mcfg, tcfg, device="cpu", with_fine=False,
                                         generator=torch.Generator().manual_seed(3))
        step = tstep.make_train_step(mcfg, rcfg, tcfg, H, W, sample_fn=sample_fn)
        gen = torch.Generator().manual_seed(4)
        if k == 1:
            for _ in range(4):
                step(state, pools, table, 0.0, gen)
        else:
            tstep.make_multi_step(step, 4)(state, pools, table, torch.tensor(0.0), gen)
        runs.append(seen)
    single, multi = runs
    assert [s for s, _ in single] == [s for s, _ in multi] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(single, multi):
        assert torch.equal(a.rays, b.rays) and torch.equal(a.rgb, b.rgb)
    # the pixel rows of each batch, from its rays: row = h/2 - y_cam * focal
    dh = max(int(H // 2 * 0.5), 1)
    for s, batch in multi:
        rot = torch.from_numpy(poses)[int(batch.image_idx), :3, :3]
        d_cam = batch.rays[:64, 3:6] @ rot  # the pixels, not their neighbours
        rows = torch.round(H * 0.5 - d_cam[:, 1] / -d_cam[:, 2] * 9.0)
        in_crop = bool(((rows >= H // 2 - dh) & (rows < H // 2 + dh)).all())
        assert in_crop == (s < 2), (s, rows.min(), rows.max())


# ---- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def object_dir(tmp_path_factory):
    """A 16 x 16 object in both Blender layouts (3 train, 1 val, 2 test)."""
    root = tmp_path_factory.mktemp("object")
    rng = np.random.default_rng(43)
    yy, xx = np.mgrid[:16, :16]
    disk = ((yy - 7.5) ** 2 + (xx - 7.5) ** 2 < 30).astype(np.uint8) * 255
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        frames = []
        for i in range(n):
            rgba = np.concatenate([rng.integers(0, 255, (16, 16, 3)), disk[..., None]], -1)
            for sub in ("", "color"):
                os.makedirs(root / split / sub, exist_ok=True)
                imwrite(str(root / split / sub / f"r_{i}.png"), rgba.astype(np.uint8))
            os.makedirs(root / split / "albedo", exist_ok=True)
            imwrite(str(root / split / "albedo" / f"r_{i}_albedo_0001.png"), rgba.astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose_spherical(90.0 * i + 10 * len(split), -30.0,
                                                              4.0).tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.6911, "frames": frames}))
    return str(root)


def _tiny_txt(tmp_path, datadir, dataset_type="blender"):
    cfg = {"expname": "tiny", "basedir": str(tmp_path), "datadir": datadir,
           "dataset_type": dataset_type, "use_viewdirs": True, "white_bkgd": True,
           "lrate_decay": 500, "netdepth": 4, "netwidth": 32, "N_samples": 8,
           "N_importance": 8, "N_rand": 16, "precrop_iters": 2, "precrop_frac": 0.5,
           "testskip": 1, "i_print": 2, "i_weights": 4, "i_testset": 4, "chunk": 128,
           "steps_per_call": 2}
    path = tmp_path / f"{dataset_type}.txt"
    path.write_text("\n".join(f"{k} = {v}" for k, v in cfg.items()))
    return str(path)


SAVE_VIEW = ("rgb", "albedo", "shading", "residual", "disp", "depth", "vis_depth")


def test_train_object_cli_trains_resumes_and_renders(tmp_path, object_dir, capsys):
    """Four CPU steps at a tiny config (blocks of 2), with a log, a
    checkpoint, a rebuild of the test views and an evaluation; then
    ``--render_only --render_test`` from the checkpoint, with the JAX
    package's directory and file names."""
    cfg = _tiny_txt(tmp_path, object_dir)
    cli.main(["--config", cfg, "--device", "cpu", "--n_iters", "4", "--no_progress", "--w_c",
              "3.0"])
    out = capsys.readouterr().out
    assert "--w_c is accepted" in out and "training complete" in out
    run = tmp_path / "tiny"
    assert (run / "checkpoints" / "000004.ckpt").exists()
    for sub in ("test_render", "train_render"):
        d = run / sub / "step_000004"
        assert all((d / f"{n}_{i:03d}.png").exists() for n in SAVE_VIEW for i in range(2)), sub
    assert (run / "train_render" / "step_000004" / "cluster" / "clusters.json").exists()
    assert (run / "train_render" / "step_000004" / "c001.png").exists()
    rows = (run / "tfb_logs" / "scalars.csv").read_text().splitlines()
    assert "1,Train/steps_per_call_effective,2.0" in rows
    # the checkpoint keeps the original .ckpt layout the JAX importer reads
    step, sd_c, sd_f = jimport.load_reference_checkpoint(str(run / "checkpoints" / "000004.ckpt"))
    arch = jimport.infer_arch(sd_c)
    assert step == 4 and sd_f is not None and (arch["depth"], arch["width"]) == (4, 32)
    assert not arch["enable_semantic"] and jimport.state_dict_to_params(sd_f)["sigma"]

    cli.main(["--config", cfg, "--device", "cpu", "--render_only", "--render_test"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    d = run / "renderonly_test_000004"
    assert all((d / f"{n}_{i:03d}.png").exists() for n in SAVE_VIEW for i in range(2))
    assert not (d / "rgb_002.png").exists()


def test_train_object_cli_guards(tmp_path, object_dir, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = _tiny_txt(tmp_path, object_dir)
    with pytest.raises(SystemExit, match="missing: --coordinator, MASTER_ADDR"):
        cli.main(["--config", cfg, "--data_parallel", "--num_processes", "2", "--device", "cpu"])
    if not torch.cuda.is_available():  # a CUDA run raises here, and never takes gloo
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            cli.main(["--config", cfg, "--data_parallel", "--coordinator", "tcp://127.0.0.1:9",
                      "--num_processes", "2", "--process_id", "0"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            cli.main(["--config", cfg, "--n_iters", "2"])


def test_train_object_cli_data_parallel_at_one_rank(tmp_path, object_dir, capsys):
    """``--data_parallel`` in a one-rank gloo group joined before the CLI:
    the pose pools padded and sharded (``dirs_cam`` whole), the state
    broadcast, the collectives in each step and render; the checkpoint
    equals the plain run's bitwise, and the CLI leaves the group it did
    not make as it found it."""
    import torch.distributed as dist

    from tests._torch_parallel_worker import free_port

    cfg = _tiny_txt(tmp_path, object_dir)
    argv = ["--config", cfg, "--device", "cpu", "--n_iters", "4", "--no_progress"]
    torch.sin(torch.linspace(0, 1, 1 << 16))  # the process's first parallel sin, off the record
    cli.main(argv + ["--expname", "plain"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        cli.main(argv + ["--expname", "group", "--data_parallel"])
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert "data-parallel: rank 0 of 1 (gloo)" in capsys.readouterr().out
    a, b = (torch.load(tmp_path / name / "checkpoints" / "000004.ckpt", weights_only=False)
            for name in ("plain", "group"))
    for key in ("network_coarse_state_dict", "network_fine_state_dict"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    assert torch.equal(a["generator_state"], b["generator_states"][0])


@pytest.mark.parametrize("dataset_type", ["blender", "blender_intrinsic"])
def test_load_object_data_dispatch(tmp_path, object_dir, dataset_type):
    from intrinsicnerf_tpu_torch.config import from_object_txt

    data = cli.load_object_data(from_object_txt(_tiny_txt(tmp_path, object_dir, dataset_type)))
    assert data.images.shape == (6, 16, 16, 4)
    assert (data.albedo_images is not None) == (dataset_type == "blender_intrinsic")
    with pytest.raises(ValueError, match="unknown object dataset_type"):
        cli.load_object_data(from_object_txt(_tiny_txt(tmp_path, object_dir, "nerf_llm")))
