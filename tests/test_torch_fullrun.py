"""The port's endurance tool (``intrinsicnerf_tpu_torch/tools/fullrun.py``)
against the JAX repo's ``tools_fullrun.py``, on the CPU.

- ``make_cfg`` writes the same YAML, field for field, at both cadences.
- The stamp's twelve checks equal ``tools_fullrun.phase_stamp``'s on the
  same synthetic run directory (the feeds stubbed alike): a 200k run
  whose ``scalars.csv`` logs the steps between the checkpoint and the
  kill twice and holds rows a kill cut off, passing, and the same run
  with one fault at a time.
- A checkpoint write cut off by a kill (``*.ckpt.tmp``) is passed over,
  and a palette that does not read gives way to an older one.
- A real SIGKILL of the port's scene CLI at the tiny config of
  ``tests/test_torch_scene_trainer.py`` (``--device cpu``), a relaunch
  that resumes the newest checkpoint the kill left with the newest
  palette no newer than it, and a ``kernel launches`` line in each
  segment's log; the relaunch trains to the end.  Kill and resume share
  one hard time limit.
"""

import json
import os

import numpy as np
import pytest
import yaml

import tools_fullrun as jfull
from intrinsicnerf_tpu_torch.tools import fullrun as tfull
from intrinsicnerf_tpu_torch.utils.image import imwrite

H, W, N_FRAMES, SPLIT = 12, 16, 8, 4
KILL_TIMEOUT_S = 240


@pytest.mark.parametrize("smoke", [False, True])
def test_make_cfg_matches_jax(tmp_path, smoke):
    (tmp_path / "w").mkdir()
    jpath, jsave, jcad = jfull.make_cfg(str(tmp_path / "w"), "/data", 2000, smoke)
    with open(jpath) as f:
        jcfg = yaml.safe_load(f)
    os.remove(jpath)
    tpath, tsave, tcad = tfull.make_cfg(str(tmp_path / "w"), "/data", 2000, smoke)
    with open(tpath) as f:
        assert yaml.safe_load(f) == jcfg
    assert (tpath, tsave, tcad) == (jpath, jsave, jcad)


# --------------------------------------------------------------- the stamp

STEPS = 200_000
FAULTS = ["none", "residual_switch", "intensity_switch", "anneal_short", "nan_scalar",
          "nan_alarm", "last_palette_missing", "two_palettes_missing", "no_resume",
          "no_palette_restore", "spc_1_in_segment_2", "psnr_below_gate", "few_rebuilds"]


def _write_run(workdir, fault):
    """A 200k run's directory as the kill and the resume leave it: rows
    from 90k to 95k logged twice (the first time with other values), a
    row cut off at the kill and one at the end of the file."""
    save = workdir / "logs_fullrun"
    (save / "tfb_logs").mkdir(parents=True)
    rows = [(1, "Train/steps_per_call_effective", 8.0)]

    def train_rows(step, offset=0.0):
        w_c = min(0.1 ** (2 - 2 * (step - 10_000) / 180_000), 1.0) if step >= 10_000 else 0.0
        b_f = min(0.5 ** (2 - 2 * (step - 10_000) / 180_000), 1.0)
        if fault == "anneal_short":
            w_c, b_f = min(w_c, 0.9), min(b_f, 0.9)
        w_res = 1.0 if step <= 100_000 else 0.02
        w_int = 0.1 if step <= 50_000 else 0.01
        if fault == "residual_switch" and step > 100_000:
            w_res = 1.0
        if fault == "intensity_switch" and step > 50_000:
            w_int = 0.1
        return [(step, "Train/Loss/total", 0.05 + offset), (step, "Train/w_residual", w_res),
                (step, "Train/w_intensity", w_int), (step, "Train/w_c_eff", w_c),
                (step, "Train/b_f", b_f)]

    for step in range(1000, 96_000, 1000):
        rows += train_rows(step, offset=1.0 if step > 90_000 else 0.0)
    text = "\n".join(f"{s},{n},{v!r}" for s, n, v in rows) + "\n95000,Train/Lo\n"
    rows = [(90_000, "Train/steps_per_call_effective",
             1.0 if fault == "spc_1_in_segment_2" else 8.0)]
    for step in range(91_000, STEPS + 1000, 1000):
        rows += train_rows(step)
    for step in range(50_000, STEPS + 1, 50_000):
        psnr = 27.0 if fault == "psnr_below_gate" and step == STEPS else 31.5
        rows += [(step, "Test/psnr", psnr), (step, "Test/miou", 0.94),
                 (step, "Test/total_acc", 0.98)]
    if fault == "nan_scalar":
        rows.append((150_000, "Train/Loss/img", float("nan")))
    text += "\n".join(f"{s},{n},{v!r}" for s, n, v in rows) + "\n200000,Tes"
    (save / "tfb_logs" / "scalars.csv").write_text(text)
    n_rebuilds = 12 if fault == "few_rebuilds" else 20
    for i in range(n_rebuilds):
        d = save / "train_render" / f"step_{(i + 1) * 10_000:06d}" / "cluster"
        d.mkdir(parents=True)
        missing = {"last_palette_missing": {n_rebuilds - 1},
                   "two_palettes_missing": {8, 9}}.get(fault, set())
        if i not in missing:
            (d / "clusters.json").write_text(json.dumps({"class_num": 1, "cluster_dirs": []}))
    log = "segment 1\nMLP compute path: fused\n"
    log += "=== SIGKILL by tools_fullrun @~95000 ===\n"
    if fault != "no_resume":
        log += "resumed from step 90000\n"
    if fault != "no_palette_restore":
        log += "cluster palette restored from rebuild @90000 (w_c=0.06, b_f=0.43)\n"
    if fault == "nan_alarm":
        log += "! [Numerical Error] view 3 map 'rgb' contains nan or inf.\n"
    (workdir / "train_log.txt").write_text(log + "training complete\n")
    return save


FEEDS = {"edit_dir": "d", "edit_frames": 12, "edit_recompose_changed": True,
         "mesh_file": "m.ply", "mesh_bytes": 120_000}


@pytest.mark.parametrize("fault", FAULTS)
def test_stamp_checks_match_jax(tmp_path, monkeypatch, fault):
    save = _write_run(tmp_path, fault)
    monkeypatch.setattr(jfull, "_feed_editor", lambda save_dir: dict(FEEDS))
    monkeypatch.setattr(jfull, "_feed_mesh", lambda *a: {})
    out = tmp_path / "jax.json"
    try:
        jfull.phase_stamp(str(tmp_path), STEPS, str(out), smoke=False)
    except AssertionError:
        pass  # a failing gate; the JSON is written first
    want = json.loads(out.read_text())
    log = (tmp_path / "train_log.txt").read_text()
    scal = tfull.read_scalars(str(save))
    checks, details = tfull.stamp_checks(scal, log, STEPS, dict(FEEDS), str(save))
    assert checks == want["checks"]
    assert all(checks.values()) == (fault == "none")
    for key in ("resumed_from_steps", "palette_restored_from", "residual_switch",
                "intensity_switch", "n_rebuilds", "n_scalar_values", "nan_alarm_lines"):
        assert json.loads(json.dumps(details[key])) == want[key], key
    assert details["final_eval"] == {k: want["final_eval"][k] for k in details["final_eval"]}
    # last write wins: the rows logged again after the resume
    assert scal["Train/Loss/total"][95_000] == 0.05


def test_scalar_rows_pass_over_cut_rows(tmp_path):
    d = tmp_path / "tfb_logs"
    d.mkdir()
    (d / "scalars.csv").write_text("1,a,1.0\n2,a,2.\n3,a\n4,b,1e\nx,a,1.0\n5,a,5.0")
    assert tfull.scalar_rows(str(tmp_path)) == [(1, "a", 1.0), (2, "a", 2.0), (5, "a", 5.0)]
    assert tfull.last_logged_step(str(tmp_path)) == 5


def test_logger_starts_a_cut_row_on_a_line_of_its_own(tmp_path):
    from intrinsicnerf_tpu_torch.train.logging_utils import TBLogger

    d = tmp_path / "tfb_logs"
    d.mkdir()
    (d / "scalars.csv").write_text("10,Train/a,1.0\n20,Train/b,0.2")  # killed mid-row
    log = TBLogger(str(d))
    log.scalars(10, {"Train/a": 3.0})
    log.close()
    assert (d / "scalars.csv").read_bytes() == b"10,Train/a,1.0\n20,Train/b,0.2\n10,Train/a,3.0\r\n"
    assert tfull.read_scalars(str(tmp_path))["Train/a"] == {10: 3.0}


# ------------------------------------------------------ the kill and resume


@pytest.fixture(scope="module")
def tiny_replica(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica")
    for sub in ("rgb", "depth", "semantic_class"):
        (root / sub).mkdir()
    traj = []
    for i in range(N_FRAMES):
        rgb = np.zeros((H, W, 3), np.uint8)
        rgb[:, : W // 2] = [180, 60, 40]
        rgb[:, W // 2:] = [40, 120, 200]
        sem = np.zeros((H, W), np.uint8)
        sem[:, : W // 2] = 3
        sem[:, W // 2:] = 7
        imwrite(str(root / "rgb" / f"rgb_{i}.png"), rgb)
        imwrite(str(root / "depth" / f"depth_{i}.png"), np.full((H, W), 2500, np.uint16))
        imwrite(str(root / "semantic_class" / f"semantic_class_{i}.png"), sem)
        pose = np.eye(4)
        pose[2, 3] = -3.0 - 0.05 * i
        traj.append(pose.reshape(-1))
    np.savetxt(str(root / "traj_w_c.txt"), np.stack(traj), delimiter=" ")
    return root


def _tiny_cfg(data_dir, save_dir, n_iters):
    """The tiny scene config of ``tests/test_torch_scene_trainer.py``, two
    steps a call, the cadences multiples of 2."""
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
                  "no_semantic_tree": False, "no_intrinsic_loss": False, "steps_per_call": 2},
        "logging": {"step_log_print": 10, "step_log_tfb": 10, "step_save_ckpt": 30,
                    "step_val": 300, "step_vis_train": 30},
    }


def test_sigkill_and_resume_of_the_scene_cli(tiny_replica, tmp_path, monkeypatch):
    # one host thread for the CLI: on a host whose cores other processes
    # keep busy, spinning worker threads slow its tiny steps forty-fold
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    steps, kill_at = 300, 70
    save = tmp_path / "run"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_tiny_cfg(tiny_replica, save, steps)))
    log_path = tmp_path / "train_log.txt"
    events = tfull.run_with_kill(str(cfg_path), str(save), str(log_path), steps, kill_at, "cpu",
                                 budget_s=KILL_TIMEOUT_S, stall_s=KILL_TIMEOUT_S, poll_s=0.1,
                                 frames=N_FRAMES, split=SPLIT, attempts=1)
    log = log_path.read_text()
    assert events["killed_at_logged_step"] >= kill_at
    assert "training complete" in log.split(tfull.KILL_MARK)[1]
    checks, details = tfull.stamp_checks(tfull.read_scalars(str(save)), log, steps,
                                         dict(FEEDS), str(save))
    assert tfull.resume_consistent(events["at_kill"], details["resumed_from_steps"],
                                   details["palette_restored_from"]), (events, details)
    # (a tiny fit renders nothing, so its depth metrics are NaN: not checked)
    for name in ("killed_and_resumed", "palette_restored_on_resume", "palettes_complete",
                 "no_nan_alarm"):
        assert checks[name], name
    assert tfull.read_scalars(str(save))["Train/steps_per_call_effective"] == {
        1: 2.0, details["resumed_from_steps"][0]: 2.0}
    reports = [tfull.segment_report(t) for t in tfull.segments(log)]
    assert len(reports) == 2
    assert reports[0]["last_logged_step"] >= kill_at and reports[1]["last_logged_step"] == steps
    for r in reports:  # the plain versions on the host launch no kernel
        assert r["launches"] == dict.fromkeys(tfull.KERNELS, 0)
        assert r["ms_per_step_median"] > 0 and r["rebuild_s"]
    assert tfull.on_disk(str(save))["checkpoints"][-1] == steps
    feeds = tfull.feed_editor(str(save), "cpu")
    assert feeds["edit_frames"] > 0


def test_a_cut_off_checkpoint_write_and_palette_are_passed_over(tiny_replica, tmp_path, capsys):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny steps; see the SIGKILL test
    try:
        _fit_cut_off_and_resume(tiny_replica, tmp_path, capsys)
    finally:
        torch.set_num_threads(threads)


def _fit_cut_off_and_resume(tiny_replica, tmp_path, capsys):
    from intrinsicnerf_tpu_torch import config as tconfig
    from intrinsicnerf_tpu_torch.data import replica as trep
    from intrinsicnerf_tpu_torch.train import checkpoint as ck
    from intrinsicnerf_tpu_torch.train import prepare as tprep
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    save = tmp_path / "run"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_tiny_cfg(tiny_replica, save, 60)))
    cfg = tconfig.from_yaml(str(cfg_path))
    tr, te = trep.default_replica_split(N_FRAMES, SPLIT)
    bundle = tprep.prepare_replica_bundle(
        cfg, trep.load_replica(str(tiny_replica), tr, te, H, W), device="cpu")
    with Trainer(cfg, bundle, device="cpu") as t:
        t.fit(progress=False)  # checkpoints and palettes at 30 and 60
    ckpt_dir = save / "checkpoints"
    (ckpt_dir / "000090.ckpt.tmp").write_bytes(b"cut off")
    (save / "train_render" / "step_000060" / "cluster" / "clusters.json").write_text('{"cla')
    assert ck.saved_steps(str(ckpt_dir)) == [30, 60]
    with Trainer(cfg, bundle, device="cpu") as t:
        assert t.maybe_resume() == 60
        out = capsys.readouterr().out
        assert "unreadable" in out and "restored from rebuild @30" in out
        assert t.cluster_manager is not None
