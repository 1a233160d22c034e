"""The port's scene trainer against the JAX package's, on a tiny Replica
directory (the layout ``tests/test_train_e2e.py`` builds), on the CPU.

- ``prepare_replica_bundle``: every pool, ray block and GT array at atol
  1e-6 (the rays are the same fp32 arithmetic; images pass through the
  same OpenCV calls).
- With the JAX trainer's weights carried across, the rebuild's rendered
  train views: albedo at atol 1e-4 (the render tests' bound for unfused
  fp32 maps: sums of fp32 terms in another order) and the semantic labels
  equal; and from those arrays both packages build the same palette
  (numpy mean-shift pinned in both).
- ``evaluate``: every metric within 1e-4, PSNR within 1e-3 dB.
- A ``.ckpt`` written by the port loads through the JAX package's
  ``import_ckpt`` to the same parameters.
- A run that saves at step 6, stops, resumes in a new ``Trainer`` and
  takes 2 more steps ends bitwise equal to 8 uninterrupted steps, in the
  parameters, the Adam state and the palette.
- The CLI trains end to end and writes what the gate reads.

The sigma head's bias is raised by 1 in the carried weights so that the
untrained fine network renders something: at this size its raw density
starts below zero everywhere, and an empty render would compare nothing.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from intrinsicnerf_tpu import config as jconfig
from intrinsicnerf_tpu.cluster import manager as jmgr
from intrinsicnerf_tpu.cluster import meanshift as jms
from intrinsicnerf_tpu.data import replica as jrep
from intrinsicnerf_tpu.tools import import_ckpt as jimport
from intrinsicnerf_tpu.train import prepare as jprep
from intrinsicnerf_tpu.train.trainer import Trainer as JTrainer
from intrinsicnerf_tpu_torch import config as tconfig
from intrinsicnerf_tpu_torch.cluster import manager as tmgr
from intrinsicnerf_tpu_torch.cluster import meanshift as tms
from intrinsicnerf_tpu_torch.data import replica as trep
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax, params_to_jax
from intrinsicnerf_tpu_torch.train import prepare as tprep
from intrinsicnerf_tpu_torch import train_scene
from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer
from intrinsicnerf_tpu_torch.train.trainer import Trainer
from intrinsicnerf_tpu_torch.utils.image import imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_FRAMES, SPLIT = 12, 16, 8, 4


@pytest.fixture(scope="module")
def tiny_replica(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica")
    for sub in ("rgb", "depth", "semantic_class"):
        (root / sub).mkdir()
    traj = []
    for i in range(N_FRAMES):
        rgb = np.zeros((H, W, 3), np.uint8)
        rgb[:, : W // 2] = [180, 60, 40]
        rgb[:, W // 2 :] = [40, 120, 200]
        depth = np.full((H, W), 2500, np.uint16)
        sem = np.zeros((H, W), np.uint8)
        sem[:, : W // 2] = 3
        sem[:, W // 2 :] = 7
        imwrite(str(root / "rgb" / f"rgb_{i}.png"), rgb)
        imwrite(str(root / "depth" / f"depth_{i}.png"), depth)
        imwrite(str(root / "semantic_class" / f"semantic_class_{i}.png"), sem)
        pose = np.eye(4)
        pose[2, 3] = -3.0 - 0.05 * i
        traj.append(pose.reshape(-1))
    np.savetxt(str(root / "traj_w_c.txt"), np.stack(traj), delimiter=" ")
    return root


def _cfg_dict(data_dir, save_dir, n_iters=60, **logging):
    """The tiny scene config of ``tests/test_train_e2e.py``."""
    log = {"step_log_print": 20, "step_log_tfb": 20, "step_save_ckpt": 30, "step_val": 50,
           "step_vis_train": 30}
    log.update(logging)
    return {
        "experiment": {"save_dir": str(save_dir), "dataset_dir": str(data_dir),
                       "dataset_type": "replica", "convention": "opencv", "width": W,
                       "height": H, "enable_semantic": True, "enable_depth": True},
        "model": {"netdepth": 3, "netwidth": 32, "chunk": 1024, "netchunk": 1024},
        "render": {"N_rays": 16, "N_samples": 8, "N_importance": 8, "perturb": 1,
                   "use_viewdirs": True, "multires": 4, "multires_views": 2,
                   "raw_noise_std": 1, "test_viz_factor": 1, "depth_range": [0.1, 10.0],
                   "white_bkgd": False},
        "train": {"lrate": "5e-4", "lrate_decay": "250e3", "N_iters": n_iters, "wgt_sem": 0.04,
                  "w_n": 0.01, "w_f": 0.005, "w_i1": 0.1, "w_i2": 0.01, "no_cluster": False,
                  "no_semantic_tree": False, "no_intrinsic_loss": False},
        "logging": log,
    }


def _write_cfg(tmp_path, d):
    path = tmp_path / "scene.yaml"
    path.write_text(yaml.dump(d))
    return str(path)


def _split():
    return trep.default_replica_split(N_FRAMES, SPLIT)


@pytest.fixture(scope="module")
def both(tiny_replica, tmp_path_factory):
    """(JAX trainer, port trainer on the CPU) on one tiny scene, the port
    carrying the JAX trainer's weights with the sigma bias raised."""
    tmp = tmp_path_factory.mktemp("both")
    path = _write_cfg(tmp, _cfg_dict(tiny_replica, tmp / "run"))
    cj, ct = jconfig.from_yaml(path), tconfig.from_yaml(path)
    tr, te = _split()
    bj = jprep.prepare_replica_bundle(cj, jrep.load_replica(str(tiny_replica), tr, te, H, W))
    bt = tprep.prepare_replica_bundle(ct, trep.load_replica(str(tiny_replica), tr, te, H, W),
                                      device="cpu")
    jt = JTrainer(cj, bj, seed=0)
    tt = Trainer(ct, bt, seed=0, device="cpu")
    params = []
    for p in (jt.state.params_coarse, jt.state.params_fine):
        p = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
        p["sigma"]["bias"] = p["sigma"]["bias"] + 1.0
        params.append(p)
    jt.state = jt.state._replace(params_coarse=params[0], params_fine=params[1])
    for m, p in zip((tt.state.model_coarse, tt.state.model_fine), params):
        m.load_state_dict(params_from_jax(p, device="cpu"))
    yield jt, tt, bj, bt
    jt.close()
    tt.close()


def _np(x):
    return np.asarray(x) if not torch.is_tensor(x) else x.numpy()


def test_prepare_replica_bundle_matches_jax(both):
    _, _, bj, bt = both
    for k in ("rays", "rgb", "depth"):
        np.testing.assert_allclose(_np(getattr(bt.pools, k)), np.asarray(getattr(bj.pools, k)),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(bt.pools.semantic.numpy(), np.asarray(bj.pools.semantic))
    np.testing.assert_array_equal(bt.pools.mask_ids.numpy(), np.asarray(bj.pools.mask_ids))
    for k in ("rays_vis", "rays_test"):
        np.testing.assert_allclose(_np(getattr(bt, k)), np.asarray(getattr(bj, k)), atol=1e-6)
    for split in ("test_gt", "train_gt"):
        gt_t, gt_j = getattr(bt, split), getattr(bj, split)
        assert gt_t.keys() == gt_j.keys()
        for k in gt_t:
            assert gt_t[k].dtype == gt_j[k].dtype
            np.testing.assert_allclose(gt_t[k], gt_j[k], atol=1e-6, err_msg=f"{split}.{k}")
    assert (bt.h, bt.w, bt.h_scaled, bt.w_scaled, bt.num_valid_classes) == (
        bj.h, bj.w, bj.h_scaled, bj.w_scaled, bj.num_valid_classes)
    np.testing.assert_array_equal(bt.colour_map, bj.colour_map)
    np.testing.assert_array_equal(bt.semantic_class_ids, bj.semantic_class_ids)


def test_replica_loader_matches_jax(tiny_replica):
    tr, te = _split()
    a = trep.load_replica(str(tiny_replica), tr, te, 6, 8)  # a resize on load
    b = jrep.load_replica(str(tiny_replica), tr, te, 6, 8)
    for split in ("train_samples", "test_samples"):
        sa, sb = getattr(a, split), getattr(b, split)
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"{split}.{k}")
    np.testing.assert_array_equal(a.semantic_classes, b.semantic_classes)
    assert (a.train_ids, a.test_ids, a.num_semantic_class) == (b.train_ids, b.test_ids,
                                                               b.num_semantic_class)


def test_rebuild_renders_and_palette_match_jax(both, monkeypatch):
    jt, tt, bj, bt = both
    views_j = list(jt.render_views(bj.rays_vis))
    views_t = list(tt.render_views(bt.rays_vis))
    assert len(views_t) == len(views_j) == len(_split()[0])
    assert views_j[0]["acc"].mean() > 0.5  # the carried weights render the scene
    pixels, labels = [], []
    for vt, vj in zip(views_t, views_j):
        np.testing.assert_allclose(vt["albedo"], vj["albedo"], atol=1e-4)
        np.testing.assert_array_equal(vt["sem_label"], vj["sem_label"])
        pixels.append(vj["albedo"][::2, ::2].reshape(-1, 3))
        labels.append(vj["sem_label"][::2, ::2].reshape(-1))
    monkeypatch.setattr(jms, "_NATIVE", None)
    monkeypatch.setattr(tms, "_native", lambda: None)
    mt, mj = tmgr.ClusterManager(class_num=tt.n_table_classes), jmgr.ClusterManager(
        class_num=jt.n_table_classes)
    mt.update_centers(np.concatenate(labels), np.concatenate(pixels), band_factor=0.25)
    mj.update_centers(np.concatenate(labels), np.concatenate(pixels), band_factor=0.25)
    assert [c is None for c in mt.clusters] == [c is None for c in mj.clusters]
    assert any(c is not None for c in mt.clusters)
    for ca, cb in zip(mt.clusters, mj.clusters):
        if ca is not None:
            for k in ("anchors", "links", "rgb_centers"):
                np.testing.assert_array_equal(getattr(ca, k), getattr(cb, k))
    tt.rebuild_clusters(30, save=False)  # the port's own rebuild runs and swaps the table
    assert tt.cluster_manager is not None and bool(tt.table.has_cluster.any())
    assert tt.last_rebuild["views"] == len(views_t) and tt.last_rebuild["meanshift"] == "numpy"


def test_evaluate_matches_jax(both):
    jt, tt, _, _ = both
    mt, mj = tt.evaluate(50, save=False), jt.evaluate(50, save=False)
    assert mt.keys() == mj.keys() and {"psnr", "miou", "total_acc", "AbsRel"} <= mt.keys()
    assert np.isfinite(mt["psnr"]) and np.isfinite(mt["AbsRel"])
    assert abs(mt["psnr"] - mj["psnr"]) < 1e-3
    for k in mt:
        if k != "psnr":
            assert abs(mt[k] - mj[k]) < 1e-4, (k, mt[k], mj[k])


def test_port_checkpoint_loads_into_jax(both, tmp_path):
    _, tt, _, _ = both
    ck = Checkpointer(str(tmp_path))
    ck.save(tt.state, 7, tt.generator)
    ck.close()
    step, sd_c, sd_f = jimport.load_reference_checkpoint(str(tmp_path / "000007.ckpt"))
    assert step == 7
    for sd, m in ((sd_c, tt.state.model_coarse), (sd_f, tt.state.model_fine)):
        got = jimport.state_dict_to_params(sd)
        ref = params_to_jax(m)
        flat_g, tree_g = jax.tree_util.tree_flatten(got)
        flat_r, tree_r = jax.tree_util.tree_flatten(ref)
        assert tree_g == tree_r
        for a, b in zip(flat_g, flat_r):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _train(tiny_replica, save_dir, tmp_path, n_iters, resume=False):
    d = _cfg_dict(tiny_replica, save_dir, n_iters=8, step_log_tfb=100, step_save_ckpt=6,
                  step_val=100, step_vis_train=4)
    cfg = tconfig.from_yaml(_write_cfg(tmp_path, d))
    tr, te = _split()
    bundle = tprep.prepare_replica_bundle(cfg, trep.load_replica(str(tiny_replica), tr, te, H, W),
                                          device="cpu")
    t = Trainer(cfg, bundle, seed=3, device="cpu")
    if resume:
        assert t.maybe_resume() == 6
    t.fit(n_iters=n_iters, progress=False)
    t.close()
    return t


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tiny_replica, tmp_path, monkeypatch):
    monkeypatch.setattr(tms, "_native", lambda: None)
    full = _train(tiny_replica, tmp_path / "full", tmp_path, 8)
    _train(tiny_replica, tmp_path / "cut", tmp_path, 6)
    resumed = _train(tiny_replica, tmp_path / "cut", tmp_path, 8, resume=True)
    assert full.global_step == resumed.global_step == 8
    for a, b in zip(full.state.optimizer.param_groups[0]["params"],
                    resumed.state.optimizer.param_groups[0]["params"]):
        assert torch.equal(a, b)
    sa, sb = full.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name]), (k, name)
    for x, y in zip(full.table[:4], resumed.table[:4]):
        assert torch.equal(x, y)
    assert (full.w_c, full.b_f) == (resumed.w_c, resumed.b_f)
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())


def test_scene_cli_end_to_end(tiny_replica, tmp_path):
    save_dir = tmp_path / "logs" / "scene"
    path = _write_cfg(tmp_path, _cfg_dict(tiny_replica, save_dir))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "intrinsicnerf_tpu_torch.train_scene", "--config_file", path,
         "--total_frames", str(N_FRAMES), "--split_step", str(SPLIT), "--no_progress",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training complete" in out.stdout and "psnr=" in out.stdout
    assert sorted(p.name for p in (save_dir / "test_render").iterdir()) == ["step_000050"]
    with open(save_dir / "tfb_logs" / "scalars.csv") as f:
        rows = list(csv.reader(f))
    assert any(name == "Test/psnr" for _, name, _ in rows)
    last = sorted((save_dir / "train_render").glob("step_*"))[-1]
    assert (last / "cluster" / "clusters.json").exists()
    for name in ("rgb_000.png", "label_000.png", "vis_label_000.png", "entropy_000.png",
                 "c000.png", "edit000.png"):
        assert (last / name).exists(), name
    assert sorted(p.name for p in (save_dir / "checkpoints").iterdir()) == [
        "000030.ckpt", "000060.ckpt"]


TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.mark.parametrize("flag,queue", [
    (["--data_parallel", "--n_iters", "2"], None),  # one process, no process group: it trains
    (["--coordinator", "localhost:1234"], "--coordinator needs --num_processes and --process_id"),
    (["--num_processes", "2"], "missing: --coordinator, MASTER_ADDR, MASTER_PORT, RANK"),
    (["--process_id", "0"], "missing: --coordinator, MASTER_ADDR, MASTER_PORT, RANK"),
    # this directory has no semantic_instance maps
    (["--region_denoising", "--total_frames", str(N_FRAMES), "--split_step", str(SPLIT)],
     "semantic_instance"),
    # host-side label draws would differ between processes: refused before the rendezvous
    (["--sparse_views", "--coordinator", "tcp://127.0.0.1:9", "--num_processes", "2",
      "--process_id", "0"], "--sparse_views uses host-side draws")])
def test_cli_refuses_what_is_not_ported(tiny_replica, tmp_path, flag, queue, monkeypatch,
                                        capsys):
    """Each flag's answer: a refusal that names what is missing or not
    supported, or, for ``--data_parallel`` alone, a run at world 1."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    path = _write_cfg(tmp_path, _cfg_dict(tiny_replica, tmp_path / "run"))
    argv = ["--config_file", path, "--device", "cpu", "--total_frames", str(N_FRAMES),
            "--split_step", str(SPLIT), "--no_progress", *flag]
    if queue is None:
        train_scene.main(argv)
        out = capsys.readouterr().out
        assert "data-parallel: rank 0 of 1" in out and "training complete" in out
        return
    with pytest.raises(SystemExit, match=queue):
        train_scene.main(argv)


def test_resume_takes_the_palette_no_newer_than_the_checkpoint(tiny_replica, tmp_path, capsys):
    """Palettes at steps 4 and 8, the checkpoint at 6: the resume takes the
    step-4 palette and its anneal; a truncated palette is passed over."""
    from intrinsicnerf_tpu_torch.train.schedules import cluster_anneal

    _train(tiny_replica, tmp_path / "run", tmp_path, 8)
    d = _cfg_dict(tiny_replica, tmp_path / "run", n_iters=8, step_vis_train=4)
    cfg = tconfig.from_yaml(_write_cfg(tmp_path, d))
    tr, te = _split()
    bundle = tprep.prepare_replica_bundle(cfg, trep.load_replica(str(tiny_replica), tr, te, H, W),
                                          device="cpu")
    with Trainer(cfg, bundle, device="cpu") as t:
        assert t.maybe_resume() == 6
        assert "restored from rebuild @4" in capsys.readouterr().out
        assert (t.w_c, t.b_f) == cluster_anneal(4, 4, 8, cfg.b_f_cap)
        ref = tmgr.ClusterManager.load(str(tmp_path / "run" / "train_render" / "step_000004" /
                                           "cluster")).to_table(device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(t.table[:4], ref[:4]))
    (tmp_path / "run" / "train_render" / "step_000004" / "cluster" / "clusters.json").write_text("{")
    with Trainer(cfg, bundle, device="cpu") as t:
        assert t.maybe_resume() == 6 and t.cluster_manager is None
        assert "unreadable" in capsys.readouterr().out


def test_checkpointer_keeps_the_newest_five(tmp_path):
    from intrinsicnerf_tpu_torch.train import checkpoint as ck
    from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
    from intrinsicnerf_tpu_torch.train.step import TrainConfig, create_train_state

    state = create_train_state(MLPConfig(depth=3, width=16, skips=(1,)), TrainConfig(),
                               device="cpu")
    c = ck.Checkpointer(str(tmp_path))
    for step in range(1, 8):
        c.save(state, step)
    assert c.latest_step() == 7
    c.close()
    assert ck.saved_steps(str(tmp_path)) == [3, 4, 5, 6, 7]
    assert not list(tmp_path.glob("*.tmp"))
