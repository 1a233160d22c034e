"""The full-length reference schedule with a SIGKILL and an auto-resume.

Twin of ``tools_fullrun.py``.  The reference trains 200k iterations, and
three schedule mechanisms engage only deep in that range: the intensity
weight's switch after 50k, the residual weight's after 100k
(``train/schedules.py:loss_weight_schedule``) and the upper half of the
``(w_c, b_f)`` cluster anneal (``cluster_anneal``), whose ``b_f`` reaches
its cap only near the end.  This tool runs the port's own scene CLI
(``python -m intrinsicnerf_tpu_torch.train_scene``, unmodified) on the
synthetic room at the published widths (8x256 coarse and fine, 512
pixels giving 1,024 paired rays, 64 + 128 samples, semantic and depth
on, kernels 1 and 2 on the packed state, 8 steps a CUDA graph replay)
through the reference cadence (log 1k, checkpoint 10k, rebuild 10k,
eval 50k), kills the CLI's whole process group with SIGKILL once mid-run
(at 95k by default, off every cadence), relaunches it, and lets
``Trainer.maybe_resume`` restore the newest checkpoint and its palette.
It then stamps a JSON with the checks of ``FULLRUN_r05.json`` under the
same names, the card's name and power limit, each segment's kernel
launches (the CLI's ``kernel launches:`` lines) and its timings, after
feeding the last artifacts to ``extract_mesh`` (128^3) and an
``EditSession`` recolour.

    python -m intrinsicnerf_tpu_torch.tools.fullrun              # the 200k run on the card
    python -m intrinsicnerf_tpu_torch.tools.fullrun --steps 2000 --kill-at 1100 --smoke
    python -m intrinsicnerf_tpu_torch.tools.fullrun --phase stamp --out logs/fullrun.json

``--smoke`` scales the cadences to 200 / 400 / 400 / 1000 (log,
checkpoint, rebuild, eval), every one a multiple of the 8 steps a call.
The run goes under ``logs/fullrun_torch`` by default; ``--device cpu``
runs it on the host through the kernels' plain versions (slow at these
widths).  It exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from intrinsicnerf_tpu_torch.tools.synthetic_replica import (
    REPO, repo_env, write_synthetic_replica)

TOTAL_FRAMES = 60
SPLIT_STEP = 5
W, H = 320, 240
# final-eval floors: the 10k convergence gate's (tools_convergence_gate.py:46-61)
GATES = {"psnr": 28.0, "miou": 0.85, "total_acc": 0.93}
KILL_MARK = "=== SIGKILL by tools/fullrun"
LAUNCH_LINE = "kernel launches: "
KERNELS = ("fused_mlp_fwd", "fused_mlp_fwd_image", "fused_mlp_bwd", "packed_heads_fwd",
           "packed_heads_bwd")


def make_cfg(workdir, data_dir, steps, smoke=False):
    """(config path, save_dir, cadence) of the run: ``tools_fullrun.make_cfg``
    field for field."""
    import yaml

    save_dir = os.path.join(workdir, "logs_fullrun")
    cadence = dict(step_log_print=1000, step_log_tfb=1000, step_save_ckpt=10000,
                   step_val=50000, step_vis_train=10000)
    if smoke:  # the same structure at scaled cadences, each a multiple of 8
        cadence = dict(step_log_print=200, step_log_tfb=200, step_save_ckpt=400,
                       step_val=1000, step_vis_train=400)
    cfg = {
        "experiment": {
            "save_dir": save_dir, "dataset_dir": data_dir, "dataset_type": "replica",
            "convention": "opencv", "width": W, "height": H,
            "enable_semantic": True, "enable_depth": True,
        },
        "model": {
            "netdepth": 8, "netwidth": 256, "netdepth_fine": 8, "netwidth_fine": 256,
            "chunk": "1024*32", "netchunk": "1024*32",
        },
        "render": {
            "N_rays": 512, "N_samples": 64, "N_importance": 128, "perturb": 1,
            "use_viewdirs": True, "multires": 10, "multires_views": 4, "raw_noise_std": 1,
            "test_viz_factor": 2, "depth_range": [0.1, 10.0], "white_bkgd": False,
        },
        "train": {
            "lrate": "5e-4", "lrate_decay": "250e3", "N_iters": steps,
            "wgt_sem": 0.04, "w_n": 0.01, "w_f": 0.005, "w_i1": 0.1, "w_i2": 0.01,
            "no_cluster": False, "no_semantic_tree": False, "no_intrinsic_loss": False,
            "steps_per_call": 8,
        },
        "logging": cadence,
    }
    path = os.path.join(workdir, "cfg_fullrun.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, save_dir, cadence


# ------------------------------------------------------------------ run


def scalar_rows(save_dir):
    """The well-formed ``(step, name, value)`` rows of the run's
    ``scalars.csv``, in file order: a row a kill cut off (too few fields,
    or a step or value that does not parse) is passed over."""
    path = os.path.join(save_dir, "tfb_logs", "scalars.csv")
    if not os.path.exists(path):
        return []
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) != 3:
                continue
            try:
                rows.append((int(row[0]), row[1], float(row[2])))
            except ValueError:
                continue
    return rows


def last_logged_step(save_dir) -> int:
    return max((r[0] for r in scalar_rows(save_dir)), default=0)


def launch(cfg_path, log_path, device, frames=TOTAL_FRAMES, split=SPLIT_STEP):
    """Start the scene CLI in a session of its own (so that one ``killpg``
    reaches every process it starts), its output appended to ``log_path``."""
    logf = open(log_path, "a")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "intrinsicnerf_tpu_torch.train_scene",
         "--config_file", cfg_path, "--total_frames", str(frames), "--split_step", str(split),
         "--no_progress", "--device", device],
        stdout=logf, stderr=subprocess.STDOUT, cwd=REPO, env=repo_env(), start_new_session=True)
    return proc, logf


def wait_for_step(proc, save_dir, target, deadline, stall_s, poll_s):
    """Poll ``scalars.csv`` until the run logs ``target`` (True) or exits
    (False); raises when it stalls for ``stall_s`` or runs past ``deadline``
    (a ``time.time()``)."""
    t_last = time.time()
    last = last_logged_step(save_dir)
    while True:
        if proc.poll() is not None:
            return False
        s = last_logged_step(save_dir)
        if s > last:
            last, t_last = s, time.time()
        if s >= target:
            return True
        if time.time() - t_last > stall_s:
            raise RuntimeError(f"run stalled: no new scalars for {stall_s}s (at step {last})")
        if time.time() > deadline:
            raise TimeoutError(f"run overran its time limit (at step {last})")
        time.sleep(poll_s)


def kill_group(proc):
    """SIGKILL ``proc``'s whole process group and reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def wait_card_free(pid, timeout_s=120.0):
    """Wait until ``nvidia-smi`` lists no compute process ``pid`` (the
    killed CLI's memory is back); True when it does so in time."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
        if str(pid) not in out.split():
            return True
        time.sleep(2)
    return False


def on_disk(save_dir) -> dict:
    """What a kill left: the complete checkpoints' steps, the checkpoint
    files cut off in their write, and the rebuilds with a complete palette."""
    from intrinsicnerf_tpu_torch.train.checkpoint import saved_steps

    ckpt_dir = os.path.join(save_dir, "checkpoints")
    rebuilds = glob.glob(os.path.join(save_dir, "train_render", "step_*"))
    return {
        "checkpoints": saved_steps(ckpt_dir),
        "cut_off_writes": sorted(os.path.basename(p) for p in
                                 glob.glob(os.path.join(ckpt_dir, "*.tmp"))),
        "palettes": sorted(int(d.rsplit("_", 1)[-1]) for d in rebuilds
                           if os.path.exists(os.path.join(d, "cluster", "clusters.json"))),
    }


def resume_consistent(at_kill: dict, resumed: List[int], restored: List[int]) -> bool:
    """Whether the relaunch resumed the newest checkpoint the kill left and
    the newest complete palette no newer than it (wherever the kill
    landed: before a checkpoint's write ended, inside a rebuild, or in
    plain steps)."""
    if not (at_kill.get("checkpoints") and resumed and restored):
        return False
    step = at_kill["checkpoints"][-1]
    palettes = [p for p in at_kill["palettes"] if p <= step]
    return resumed[0] == step and bool(palettes) and restored[0] == palettes[-1]


def build_kernels():
    """Build kernels 1 and 2 and the heads' kernels before the first
    launch, so that no kill can land inside a build (the CLIs find them in
    ``_build/``)."""
    from intrinsicnerf_tpu_torch.ops import build

    for name in ("fused_mlp_fwd", "fused_mlp_bwd", "packed_heads"):
        build.build(name)


def run_with_kill(cfg_path, save_dir, log_path, steps, kill_at, device, budget_s, stall_s,
                  poll_s, frames=TOTAL_FRAMES, split=SPLIT_STEP, attempts=3):
    """Train to ``kill_at``, SIGKILL the CLI's process group, relaunch and
    train to ``steps`` (up to ``attempts`` relaunches, as the JAX tool),
    all within ``budget_s``; returns the run's events."""
    events = {"wall_start": time.time()}
    deadline = events["wall_start"] + budget_s
    proc, logf = launch(cfg_path, log_path, device, frames, split)
    print(f"segment 1 launched (pid {proc.pid}); killing at step {kill_at}", flush=True)
    try:
        reached = wait_for_step(proc, save_dir, kill_at, deadline, stall_s, poll_s)
    finally:  # reached, exited or stalled: nothing of the group outlives this
        kill_group(proc)
        logf.close()
    if not reached:
        raise RuntimeError(f"segment 1 exited rc={proc.returncode} before step {kill_at}; "
                           f"see {log_path}")
    events["segment1_s"] = time.time() - events["wall_start"]
    events["killed_at_logged_step"] = last_logged_step(save_dir)
    events["at_kill"] = on_disk(save_dir)
    print(f"SIGKILL at logged step {events['killed_at_logged_step']}", flush=True)
    with open(log_path, "a") as f:
        f.write(f"\n{KILL_MARK} @~{kill_at} ===\n")
    if device.startswith("cuda"):
        events["card_free_after_kill"] = wait_card_free(proc.pid)
    for attempt in range(attempts):
        t_seg = time.time()
        proc, logf = launch(cfg_path, log_path, device, frames, split)
        print(f"segment 2 launched (pid {proc.pid}, attempt {attempt + 1})", flush=True)
        try:
            done = not wait_for_step(proc, save_dir, steps + 1, deadline, stall_s, poll_s)
        except BaseException as e:  # a stall is retried; the deadline or a signal ends the run
            kill_group(proc)
            logf.close()
            if not isinstance(e, RuntimeError):
                raise
            print(f"segment 2 attempt {attempt + 1}: {e}; retrying", flush=True)
            time.sleep(min(120.0, stall_s / 10, max(0.0, deadline - time.time())))
            continue
        proc.wait()
        logf.close()
        if done and proc.returncode == 0:
            events["segment2_s"] = time.time() - t_seg
            break
        raise RuntimeError(f"segment 2 exited rc={proc.returncode}; see {log_path}")
    else:
        raise RuntimeError(f"segment 2 never completed after {attempts} attempts")
    events["wall_s"] = round(time.time() - events["wall_start"], 1)
    return events


def phase_run(workdir, steps, kill_at, smoke, device):
    data_dir = os.path.join(workdir, "data")
    if not os.path.isdir(os.path.join(data_dir, "rgb")):
        print("writing the synthetic room ...", flush=True)
        write_synthetic_replica(data_dir, TOTAL_FRAMES, W, H)
    cfg_path, save_dir, _ = make_cfg(workdir, data_dir, steps, smoke)
    if device.startswith("cuda"):
        build_kernels()
    events = run_with_kill(
        cfg_path, save_dir, os.path.join(workdir, "train_log.txt"), steps, kill_at, device,
        budget_s=3600 if smoke else 4 * 3600, stall_s=900 if smoke else 1800,
        poll_s=1.0 if smoke else 10.0)
    with open(os.path.join(workdir, "events.json"), "w") as f:
        json.dump(events, f)
    print(f"run complete in {events['wall_s']}s", flush=True)


# ---------------------------------------------------------------- stamp


def read_scalars(save_dir) -> Dict[str, Dict[int, float]]:
    """``{name: {step: value}}``; a step logged twice (the steps between
    the restored checkpoint and the kill) keeps its last write."""
    out: Dict[str, Dict[int, float]] = {}
    for step, name, val in scalar_rows(save_dir):
        out.setdefault(name, {})[step] = val
    return out


def segments(log: str) -> List[str]:
    """The train log split at the kill marks: one text per process."""
    return log.split(KILL_MARK)


def segment_report(text: str) -> dict:
    """What one process's log says: its last ``kernel launches`` line, its
    median ms per step between launch lines (blocks of plain steps), and
    its rebuilds' and evaluations' seconds."""
    lines = []
    for ln in text.splitlines():
        if ln.startswith(LAUNCH_LINE):
            try:
                lines.append(json.loads(ln[len(LAUNCH_LINE):]))
            except json.JSONDecodeError:
                continue  # a line the kill cut off
    rates = [1e3 * (b["seconds"] - a["seconds"]) / (b["step"] - a["step"])
             for a, b in zip(lines, lines[1:]) if b["step"] > a["step"]]
    rebuild_s = [float(r) + float(m) for r, m in re.findall(
        r"cluster rebuild @\d+: render ([\d.]+)s .*?mean-shift ([\d.]+)s", text)]
    eval_s = [float(x) for x in re.findall(r"eval @\d+: .*\(([\d.]+) s\)", text)]
    last = lines[-1] if lines else {}
    return {
        "last_logged_step": last.get("step"),
        "launches": {k: last.get(k, 0) for k in KERNELS},
        "ms_per_step_median": float(np.median(rates)) if rates else None,
        "rebuild_s": rebuild_s,
        "eval_s": eval_s,
    }


def stamp_checks(scal, log, steps, feeds, save_dir):
    """(checks, details) of a finished run: ``tools_fullrun.phase_stamp``'s
    twelve checks under its names, with its rules (the switches gated
    only past 100k steps, the floors only at 200k)."""
    w_res = scal.get("Train/w_residual", {})
    w_int = scal.get("Train/w_intensity", {})
    w_c = scal.get("Train/w_c_eff", {})
    b_f = scal.get("Train/b_f", {})
    spc = scal.get("Train/steps_per_call_effective", {})
    res_sw = int_sw = None
    if steps > 100_000:
        res_sw = {"at_100k": w_res.get(100_000), "at_101k": w_res.get(101_000)}
        int_sw = {"at_50k": w_int.get(50_000), "at_51k": w_int.get(51_000)}
    rebuild_dirs = sorted(glob.glob(os.path.join(save_dir, "train_render", "step_*")))
    palettes = [d for d in rebuild_dirs
                if os.path.exists(os.path.join(d, "cluster", "clusters.json"))]
    all_finite = all(np.isfinite(v) for by_step in scal.values() for v in by_step.values())
    test_psnr = scal.get("Test/psnr", {})
    final_step = max(test_psnr) if test_psnr else None
    final = {"step": final_step, "psnr": test_psnr.get(final_step),
             "miou": scal.get("Test/miou", {}).get(final_step),
             "total_acc": scal.get("Test/total_acc", {}).get(final_step)}
    resumed = [int(x) for x in re.findall(r"resumed from step (\d+)", log)]
    restores = [int(x) for x in re.findall(r"cluster palette restored from rebuild @(\d+)", log)]
    nan_alarms = log.count("[Numerical Error]")
    checks = {
        "residual_switch_engaged": res_sw is None or (
            res_sw["at_100k"] == 1.0 and res_sw["at_101k"] == 0.02),
        "intensity_switch_engaged": int_sw is None or (
            int_sw["at_50k"] == 0.1 and int_sw["at_51k"] == 0.01),
        "anneal_reaches_caps": (max(w_c.values(), default=0) >= 0.999
                                and max(b_f.values(), default=0) >= 0.999)
        if steps > 100_000 else True,
        "rebuilds_completed": len(rebuild_dirs) >= (
            20 if steps >= 200_000 else max(len(rebuild_dirs), 1)),
        # a kill inside a rebuild may leave one directory without its
        # palette; the last rebuild must always have one
        "palettes_complete": len(palettes) >= len(rebuild_dirs) - 1 and bool(rebuild_dirs)
        and os.path.exists(os.path.join(rebuild_dirs[-1], "cluster", "clusters.json")),
        "steps_per_call_8_both_segments": sorted(set(spc.values())) == [8.0],
        "all_scalars_finite": all_finite,
        "no_nan_alarm": nan_alarms == 0,
        "killed_and_resumed": len(resumed) >= 1,
        "palette_restored_on_resume": len(restores) >= 1,
        "final_metrics_beat_10k_gate": steps < 200_000 or (
            final["psnr"] is not None and final["psnr"] > GATES["psnr"]
            and final["miou"] > GATES["miou"] and final["total_acc"] > GATES["total_acc"]),
        "mesh_and_editor_fed": feeds["mesh_bytes"] > 10_000 and feeds["edit_frames"] > 0,
    }

    def every(series):
        keys = sorted(series)
        return {s: series[s] for s in keys[:: max(len(keys) // 12, 1)]}

    details = {
        "resumed_from_steps": resumed, "palette_restored_from": restores,
        "residual_switch": res_sw, "intensity_switch": int_sw,
        "w_c_trajectory": every(w_c), "b_f_trajectory": every(b_f),
        "n_rebuilds": len(rebuild_dirs),
        "n_scalar_values": sum(len(v) for v in scal.values()),
        "nan_alarm_lines": nan_alarms, "final_eval": final,
    }
    return checks, details


def feed_mesh(workdir, cfg_path, device):
    """The last checkpoint through the port's ``extract_mesh`` at 128^3."""
    mesh_path = os.path.join(workdir, "mesh_final.ply")
    r = subprocess.run(
        [sys.executable, "-m", "intrinsicnerf_tpu_torch.extract_mesh", "--config_file", cfg_path,
         "--grid_dim", "128", "--out", mesh_path, "--total_frames", str(TOTAL_FRAMES),
         "--split_step", str(SPLIT_STEP), "--device", device],
        capture_output=True, text=True, cwd=REPO, env=repo_env(), timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"extract_mesh failed:\n{r.stderr[-3000:]}")
    return {"mesh_file": mesh_path, "mesh_bytes": os.path.getsize(mesh_path)}


def feed_editor(save_dir, device):
    """The last rebuild's renders and palette through an ``EditSession``:
    compose, recolour one cluster, compose again."""
    from intrinsicnerf_tpu_torch.tools.editing import EditSession

    d = sorted(glob.glob(os.path.join(save_dir, "train_render", "step_*")))[-1]
    s = EditSession(d, os.path.join(d, "cluster"), device=device)
    ids = s.frame_ids()
    if not ids:
        raise RuntimeError(f"no albedo frames in {d}")
    img = s.compose(ids[0])
    sem, cid = s.pick(ids[0], img.shape[0] // 2, img.shape[1] // 2)
    if s.get_cluster_color(sem, cid) is not None:
        s.set_cluster_color(sem, cid, np.array([0.9, 0.1, 0.1], np.float32))
    img2 = s.compose(ids[0])
    if not (np.isfinite(img).all() and np.isfinite(img2).all() and img.ndim == 3):
        raise RuntimeError("the edit session composed a non-finite image")
    return {"edit_dir": d, "edit_frames": len(ids),
            "edit_recompose_changed": bool(np.abs(img2 - img).max() > 1e-3)}


def scene_label() -> str:
    """The room as the CLI splits it (``--total_frames``, ``--split_step``)."""
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split

    train, test = default_replica_split(TOTAL_FRAMES, SPLIT_STEP)
    return (f"hard synthetic room, {W}x{H}, {TOTAL_FRAMES} frames "
            f"({len(train)} train, {len(test)} test)")


def phase_stamp(workdir, steps, out, smoke, device) -> dict:
    from intrinsicnerf_tpu_torch.tools.bench import device_info

    save_dir = os.path.join(workdir, "logs_fullrun")
    cfg_path = os.path.join(workdir, "cfg_fullrun.yaml")
    with open(os.path.join(workdir, "train_log.txt")) as f:
        log = f.read()
    events = {}
    if os.path.exists(os.path.join(workdir, "events.json")):
        with open(os.path.join(workdir, "events.json")) as f:
            events = json.load(f)
    feeds = feed_editor(save_dir, device)
    feeds.update(feed_mesh(workdir, cfg_path, device))
    checks, details = stamp_checks(read_scalars(save_dir), log, steps, feeds, save_dir)
    ckpts = sorted(int(os.path.basename(p)[:-5]) for p in
                   glob.glob(os.path.join(save_dir, "checkpoints", "*.ckpt"))
                   if os.path.basename(p)[:-5].isdigit())
    info = device_info(device)
    result = {
        "steps": steps,
        "schedule": {"ckpt_every": 10000, "rebuild_every": 10000, "eval_every": 50000,
                     "steps_per_call": 8} if not smoke else "smoke-scaled",
        "scene": scene_label(),
        "device": info["name"],
        "power_limit": info["power_limit"],
        "wall_s": events.get("wall_s"),
        "segment_s": [events.get("segment1_s"), events.get("segment2_s")],
        "killed_at_logged_step": events.get("killed_at_logged_step"),
        "card_free_after_kill": events.get("card_free_after_kill"),
        "at_kill": events.get("at_kill"),
        **details,
        "resume_consistent": resume_consistent(events.get("at_kill", {}),
                                               details["resumed_from_steps"],
                                               details["palette_restored_from"]),
        "segments": [segment_report(t) for t in segments(log)],
        "n_checkpoints": len(ckpts),
        "latest_checkpoint": ckpts[-1] if ckpts else None,
        "final_gates": GATES,
        "feeds": feeds,
        "checks": checks,
        "pass": all(checks.values()),
    }
    path = os.path.join(REPO, out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=str)
        f.write("\n")
    print(json.dumps({k: result[k] for k in ("final_eval", "checks", "pass", "wall_s")},
                     indent=2, default=str))
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="all", choices=["all", "run", "stamp"])
    ap.add_argument("--steps", type=int, default=200000)
    ap.add_argument("--kill-at", type=int, default=95000)
    ap.add_argument("--workdir", default=os.path.join(REPO, "logs", "fullrun_torch"))
    ap.add_argument("--out", default="FULLRUN_torch.json",
                    help="the JSON, relative to the repo root")
    ap.add_argument("--smoke", action="store_true", help="scaled cadences for a rig run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.phase in ("all", "run"):
        phase_run(args.workdir, args.steps, args.kill_at, args.smoke, args.device)
    if args.phase in ("all", "stamp"):
        result = phase_stamp(args.workdir, args.steps, args.out, args.smoke, args.device)
        if not result["pass"]:
            print(f"FULLRUN gate FAILED: {result['checks']}", file=sys.stderr)
            return 1
        print("FULLRUN GATE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
