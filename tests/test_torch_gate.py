"""The port's convergence-gate twin reads a run as the JAX gate does.

A fake run directory stands in for a trained scene: its test renders
are the generator's GT albedo (so the albedo MAE is 0) and a residual of
a known level, and its palette is built from the GT albedo.  Every
reading of the twin (the CSV metrics, the decomposition statistics, the
albedo fidelity, the palette check) must equal the JAX gate's reading of
the same files, and the synthetic room written through the port's
``imageio``-free runner must equal the tool's own output.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

import tools_convergence_gate as jgate
from intrinsicnerf_tpu_torch.cluster.manager import ClusterManager
from intrinsicnerf_tpu_torch.tools import convergence_gate as tgate
from intrinsicnerf_tpu_torch.tools.synthetic_replica import write_synthetic_replica
from intrinsicnerf_tpu_torch.utils.image import imread, imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 32, 24


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    out = tmp_path_factory.mktemp("room")
    report = write_synthetic_replica(str(out / "data"), tgate.TOTAL_FRAMES, W, H)
    assert report.startswith(f"wrote {tgate.TOTAL_FRAMES} frames")
    return out / "data"


@pytest.fixture(scope="module")
def fake_run(room, tmp_path_factory):
    save = tmp_path_factory.mktemp("run")
    test_ids = [i for i in range(tgate.TOTAL_FRAMES) if i % tgate.SPLIT_STEP == 2]
    tdir = save / "test_render" / "step_000010"
    tdir.mkdir(parents=True)
    for k, i in enumerate(test_ids):
        albedo = imread(str(room / "gt_albedo" / f"albedo_{i}.png"))
        imwrite(str(tdir / f"albedo_{k:03d}.png"), albedo)
        imwrite(str(tdir / f"residual_{k:03d}.png"), np.full((H, W, 3), 10 + k, np.uint8))
    px, lab = [], []
    for i in range(0, tgate.TOTAL_FRAMES, tgate.SPLIT_STEP):
        a = imread(str(room / "gt_albedo" / f"albedo_{i}.png")).reshape(-1, 3) / 255.0
        sem = imread(str(room / "semantic_class" / f"semantic_class_{i}.png")).reshape(-1)
        px.append(a)
        lab.append(sem)
    classes, lab = np.unique(np.concatenate(lab), return_inverse=True)  # dense, as the loader
    mgr = ClusterManager(class_num=len(classes))
    mgr.update_centers(lab, np.concatenate(px), band_factor=0.25)
    mgr.save(str(save / "train_render" / "step_000010" / "cluster"))
    (save / "tfb_logs").mkdir()
    with open(save / "tfb_logs" / "scalars.csv", "w", newline="") as f:
        w = csv.writer(f)
        for step, name, v in ((5, "Test/psnr", 20.0), (10, "Train/Loss/total", 0.1),
                              (10, "Test/psnr", 29.5), (10, "Test/miou", 0.9)):
            w.writerow([step, name, v])
    return save


def test_gate_readings_equal_the_jax_gate(room, fake_run):
    assert tgate.THRESHOLDS == jgate.THRESHOLDS
    assert (tgate.TOTAL_FRAMES, tgate.SPLIT_STEP) == (jgate.TOTAL_FRAMES, jgate.SPLIT_STEP)
    run, data = str(fake_run), str(room)
    assert tgate.read_test_metrics(run) == jgate.read_test_metrics(run) == {
        "psnr": 29.5, "miou": 0.9}
    assert tgate.decomposition_stats(run) == jgate.decomposition_stats(run)
    assert tgate.albedo_fidelity(run, data) == jgate.albedo_fidelity(run, data) == 0.0
    got = tgate.check_cluster_palette(run, data)
    assert got == jgate.check_cluster_palette(run, data)
    assert got["observed_gt_colors"] > 10 and got["palette_recall"] > 0.5


def test_gate_configs_match_the_jax_gate(tmp_path):
    import yaml

    for sub in ("j", "t", "p"):
        (tmp_path / sub).mkdir()
    for ablation in ("none", "no_intrinsic", "no_cluster"):
        pj, _ = jgate.make_cfg(str(tmp_path / "j"), "DATA", ablation, 1000, ablation)
        pt, _ = tgate.make_cfg(str(tmp_path / "t"), "DATA", ablation, 1000, ablation)
        cj, ct = (yaml.safe_load(open(p)) for p in (pj, pt))
        for c in (cj, ct):
            c["experiment"].pop("save_dir")
        assert ct == cj, ablation
        plain = yaml.safe_load(open(tgate.make_cfg(str(tmp_path / "p"), "DATA", ablation, 1000,
                                                   ablation, fused=False)[0]))
        assert plain.pop("use_fused_kernel") is False
        plain["experiment"].pop("save_dir")
        assert plain == cj, ablation


def test_synthetic_room_equals_the_tools_own_output(room, tmp_path):
    import imageio.v2 as imageio

    subprocess.run([sys.executable, os.path.join(ROOT, "tools_make_synthetic_replica.py"),
                    str(tmp_path), "--frames", str(tgate.TOTAL_FRAMES), "--width", str(W),
                    "--height", str(H)], check=True, capture_output=True, cwd=ROOT, timeout=300)
    for sub, name in (("rgb", "rgb"), ("depth", "depth"), ("semantic_class", "semantic_class"),
                      ("gt_albedo", "albedo")):
        for i in (0, 7, 31, 59):
            a = imageio.imread(str(tmp_path / sub / f"{name}_{i}.png"))
            b = imageio.imread(str(room / sub / f"{name}_{i}.png"))
            assert a.dtype == b.dtype and np.array_equal(a, b), (sub, i)
    assert (tmp_path / "traj_w_c.txt").read_text() == (room / "traj_w_c.txt").read_text()


def test_gate_refuses_to_overwrite_a_tracked_stamp():
    with pytest.raises(SystemExit, match="not overwritten"):
        tgate.main(["--out", os.path.join(ROOT, "CONVERGENCE_r05.json"), "--device", "cpu"])
