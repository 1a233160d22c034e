#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per kernel, all at once), holds each against its plain PyTorch
version on the card at the shapes its path gives it, and drives the two
paths of the Replica scene configuration
(``configs/scene/replica_room_0.yaml``: 8x256 trunk with the skip, five
heads, C = 27 semantic classes, 64 + 128 samples) from seeded random
weights:

- kernel 1 (the fused-MLP forward) and its weight image against their
  plain versions from one point to the view's fine chunk, bitwise across
  two launches, then kernel 1 rebuilt with one part cut out at a time
  (``tools/fwd_ablate.py``) and timed;
- serving: one full 320x240 view through ``render_views`` (32,768-ray
  chunks, the last one short), which must go through kernel 1 and agree
  with the plain version on a subset of its rays;
- training: ``train/step.py:make_train_step`` at 512 pairs per step on
  four synthetic 320x240 views, which must launch kernels 1 and 2 twice
  each per step, keep every loss term finite, move the parameters,
  lower the loss on a fixed batch, and agree with the same step run by
  the plain versions on the host; then ``make_multi_step``: 8 steps
  captured as one CUDA graph and replayed, against 8 eager steps from
  the same state and generator (bitwise where two eager runs are),
  kernels 1 and 2 found by name 16 times each in a profiled replay; the
  packed training state (``PackedMLP``, what the step trains here)
  against the unpacked one from one seed, 8 graphed steps each held
  bitwise after every step, and both states' replays split by kernel
  name (kernel 1, its image, kernel 2, the rest by kind);
- the forward probe (kernel 3, ``tools/fwd_probe.py``): its build's
  registers and spills (none allowed), its weight image bitwise, every
  case of its sweep (each variant, tile, layer count and output type),
  the layer counts at the 128-point tile and a ragged point count, each
  held against its plain version with a bitwise repeat, the cost of one
  more layer per tile, then the sweep itself;
- the scene trainer (``train/trainer.py:Trainer``, as the scene CLI runs
  it) on a synthetic room written by ``tools_make_synthetic_replica.py``:
  an evaluation, 400 steps with two cluster rebuilds, a checkpoint and
  an evaluation, then a resume in a second trainer that must restore the
  step, the parameters, the Adam state and the palette exactly and
  train on; once one step per call, once ``steps_per_call`` 10 (blocks
  of 10 steps as graph replays, the cadences landing as before, and a
  replay after the last rebuild reading the new table); the editing
  session (``tools/editing.py``) on the second run's last rebuild, its
  cluster search on the card equal to the host's;
- the bench (``tools/bench.py``) at 1 and 8 steps per call;
- the other scene data on the same room: written as a ScanNet scan
  (1296x968 frames) and loaded at ``configs/scene/scannet_template.yaml``
  (324x243, ``nyu40``, depth on): the step (its kernels by name, a slice
  against the host, kernels 1 and 2 at the scan's C and at C = 40 and 13
  against their plain versions, 8 steps as one replay, a 324x243 view),
  the CLI twin for 400 steps at 10 per call with its rebuilds and
  evaluations and a resume in a second process; the Replica config with
  ``render.no_batching: false`` (8 steps as one replay against eager
  ones, pairs across images, 200 CLI steps); the Replica-NYU layout
  (100 CLI steps, an evaluation against the ground truth in the NYU-13
  palette); each of the five label-degradation flags for 30 steps, its
  pools holding the degraded labels;
- the object pipeline at ``configs/object/lego.txt`` (8x256 with view
  directions, the semantic head off, 1,024 pairs of 64 + 128 samples,
  precrop for 500 steps) on the synthetic object of
  ``tools_make_synthetic_blender.py`` at 800x800 (400x400 after
  ``half_res``): the step (its kernels by name, a slice against the
  host, kernels 1 and 2 at its 131,072 / 393,216-point calls against
  their plain versions), 8 steps as one graph replay across the end of
  the precrop warm-up, the packed state against the unpacked one there
  as on the Replica step, a 400x400 view, the CLI twin for 600 steps at 10
  per call with its rebuilds and evaluations, a resume in a second
  process, ``--render_only --render_test``, the blender_intrinsic loader,
  LLFF in NDC on five of its views, and the cube check of
  ``tools/validate_convergence.py`` (held-out PSNR > 20);
- mesh extraction (``extract_mesh``, the CLI twin) from the ScanNet
  run's checkpoint on a 256^3 grid (kernel 1 once per 131,072 points,
  twice per 4,096-ray chunk of the vertex-colour render; a slice of the
  occupancy against the plain version; the PLY read back), then from the
  object run's at 128^3;
- the last tools: the kernel bench (``tools/kernel_bench.py``: kernels 1
  and 2 at 65,536 and 196,608 points and the graphed step, beside their
  bounds), the world-1 row of ``tools/bench_scaling.py`` (a one-rank NCCL
  group in a process of its own) against the bench, a reference-format
  checkpoint of the graphed scene run imported by the import CLI and
  resumed in a second process, whose 320x240 view must be bitwise the
  original model's, and last the endurance tool's rig
  (``tools/fullrun.py --smoke``: 2,000 steps, the scene CLI SIGKILLed past
  step 1,100 and resumed, kernels 1 and 2 launched in both segments).

Each path runs with the launch counts set to 0 just before it and read
just after; a graph replay's launches are its replays times the
launches recorded into it (``.captured``).  It prints what it measured; the last line is ``{"ok":
true, "device": {...}}``, and any failed phase exits non-zero and prints
no such line.  It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "scene", "replica_room_0.yaml")
N_CLASSES = 27  # Replica room_0's semantic classes, as the JAX bench uses
H, W = 240, 320
SUBSET = 2048  # rays re-rendered through the plain version on the host
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# kernel vs plain, per output slice: max |d| / max(|plain|, 1), as tests/test_fused_mlp.py
KERNEL_TOL = 2e-2
# view vs plain on the subset: mean |d| / max(|plain|, 1).  bf16 noise in
# sigma moves some importance samples along their ray, so a per-ray max
# would measure that resampling, not the kernel
VIEW_TOL = 1e-2
# the plain view's mean opacity on the subset must exceed this, so that
# two empty views cannot agree
VIEW_ACC_FLOOR = 0.02
# kernel 2 vs plain over the real parameter slots, overall and per block:
# the gradient bounds of tests/test_fused_mlp.py
BWD_COS, BWD_REL = 0.999, 1e-2
# the training step on the card vs the same step by the plain versions
STEP_REL, STEP_COS = 1e-2, 0.99
N_VIEWS = 4  # synthetic training views
# kernel 3 vs plain: max |d| / max(|plain|, 1), the bound of kernels 1 and 2
PROBE_TOL = 2e-2
PROBE_N, PROBE_RAGGED = 196_608, 100_003
# the scene run: the Replica config with only the data paths and cadences
# changed; 20 frames split every 5th (4 train and 4 test views)
SCENE_FRAMES, SCENE_SPLIT, SCENE_STEPS, SCENE_MORE = 20, 5, 400, 50
SCENE_CADENCE = {"step_log_tfb": 50, "step_vis_train": 200, "step_save_ckpt": 200,
                 "step_val": 400}
SAVE_VIEW_FILES = ("rgb", "albedo", "shading", "residual", "disp", "depth", "vis_depth",
                   "label", "vis_label", "entropy", "vis_entropy")
TIMED_STEPS, WARM_STEPS, FIXED_STEPS = 20, 3, 30
GRAPH_K, GRAPH_CALLS = 8, 5  # train_graph: steps per replay, replays per timed window
# the kernels of one training step's graph (kernel 1 and its weight image;
# kernel 2: its weight image, activation pass, weight GEMM and row sums),
# launches per forward or backward call
REPLAY_KERNELS = {"fused_mlp_fwd_kernel": 1, "fwd_wimg_kernel": 1, "bwd_act_wimg_kernel": 1,
                  "bwd_act_wgmma_kernel": 1, "bwd_wgrad_gemm_kernel": 1, "reduce_rows_kernel": 2}
SCENE_K = 10  # the graphed scene run's steps per call: divides 50, 200, 400 and the resume's 50
# a graphed block against the same steps run eagerly, where eager runs are
# not bitwise: the JAX scan test's bounds (tests/test_train_step.py)
GRAPH_TOTAL_RTOL, GRAPH_PARAM_ATOL, GRAPH_PARAM_RTOL = 1e-6, 1e-6, 1e-5
SLICE_PAIRS = 64  # pairs of the step run on both the card and the host
# the packed training state against the unpacked one: graphed steps held
# bitwise after each, then both paths' replays profiled by kernel name
PACKED_STEPS = 8
# the device time outside kernels 1 and 2, by what launched it: kernel
# name substrings (a graph replay shows kernels, not host ops)
REST_KINDS = (("adam", ("multi_tensor_apply", "adam", "Adam")),
              ("pack_cat", ("CatArrayBatchedCopy",)), ("fill", ("FillFunctor",)),
              ("copy_cast", ("copy_kernel", "bfloat16_copy", "direct_copy")))
CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
# the object pipeline: configs/object/lego.txt on the synthetic object at
# 800x800 (24 train, 1 val, 5 test views; half_res makes the views 400x400)
OBJ_CONFIG = os.path.join(ROOT, "configs", "object", "lego.txt")
OBJ_INTRINSIC_CONFIG = os.path.join(ROOT, "configs", "object", "intrinsic_lego.txt")
OBJ_RES, OBJ_VIEWS = 800, (24, 1, 5)
# the CLI run: 600 steps at 10 per call, crossing the precrop boundary at
# 500; a resume for 50 more; 20 steps of the blender_intrinsic loader
OBJ_STEPS, OBJ_MORE, OBJ_K, OBJ_INTRINSIC_STEPS = 600, 50, 10, 20
OBJ_CADENCE = {"i_print": 100, "i_weights": 300, "i_testset": 300}
OBJ_SAVE_VIEW = SAVE_VIEW_FILES[:7]  # no semantic maps
# LLFF in NDC: configs/object/fern.txt on 5 adjacent train views of the
# object written as an LLFF capture (images_8: 100x100), 50 steps
OBJ_LLFF_CONFIG = os.path.join(ROOT, "configs", "object", "fern.txt")
OBJ_LLFF_STEPS = 50
# the other scene data: configs/scene/scannet_template.yaml on the scene
# phases' room written as a ScanNet scan (1296x968 frames, 324x243 after
# the loader; 20 frames: 4 train, 4 test); its fit at 10 steps per call
# (log every 50, rebuild and checkpoint every 200, eval at 400), a resume
# for 50 more; the all-images sampler, Replica-NYU and the degradations on
# the Replica config at the room
SCANNET_CONFIG = os.path.join(ROOT, "configs", "scene", "scannet_template.yaml")
SCANNET_SCENE = "scene0088_00"
SCANNET_WANT = ((8, 256, (4,), True, True), (512, 64, 128, 1.0, 1.0),
                (324, 243, "nyu40", True, True), 32768)
SCANNET_STEPS, SCANNET_MORE, SCANNET_K = 400, 50, 10
SCANNET_CADENCE = {"step_log_print": 50, "step_log_tfb": 50, "step_vis_train": 200,
                   "step_save_ckpt": 200, "step_val": 400}
NYU_WIDTHS = (40, 13)  # kernels 1 and 2 held at NYU-40 and NYU-13 too
ALL_IMAGES_STEPS, NYU_STEPS, DEGRADE_STEPS = 200, 100, 30
CLI_LOG = 50  # the all-images and Replica-NYU runs' log cadence
DEGRADATIONS = {
    "sparse_views": ["--sparse_views", "--sparse_ratio", "0.5"],
    "pixel_denoising": ["--pixel_denoising", "--pixel_noise_ratio", "0.3"],
    "region_denoising": ["--region_denoising", "--region_noise_ratio", "0.5"],
    "super_resolution": ["--super_resolution", "--dense_sr", "8"],
    "label_propagation": ["--label_propagation", "--partial_perc", "0.05"]}
# mesh extraction: the ScanNet fit's checkpoint at 256^3 (16,777,216 points,
# 128 kernel-1 calls of 131,072), the object fit's at 128^3
MESH_GRID, OBJ_MESH_GRID, MESH_PROBE = 256, 128, 64
# what lego.txt sets: the MLP, the samples, the batch, half_res and precrop
OBJ_WANT = ((8, 256, True, True, False), (64, 128, True, 1.0), (1024, "mask"), (True, 500, 0.5))


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>`` for the first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no answer"


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def network_macs(model) -> int:
    """Multiply-adds per point of the network's own layers (its reference
    state_dict's weights, in either layout)."""
    return sum(v.numel() for k, v in model.state_dict().items() if k.endswith(".weight"))


def fused_work(n_points: int, macs_per_point: int, n_weights: int, n_bias: int):
    """(FLOP, bytes) of one fused-MLP forward over ``n_points``: the
    network's own multiply-adds per point (its layers' unpadded weight
    counts, not the kernel's padded blocks); each point reads 8 fp32 and
    writes 128 bf16, and the packed weights (bf16) and biases (fp32) are
    read once."""
    flops = 2.0 * macs_per_point * n_points
    nbytes = n_points * (8 * 4 + 128 * 2) + n_weights * 2 + n_bias * 4
    return flops, nbytes


def loss_cotangent(out, n_used: int, gen, torch):
    """The bf16 cotangent of ``0.5 * sum((out - target)^2) / P`` over the
    output columns the model reads, with a seeded uniform target: coherent
    across points, as a training loss's is."""
    target = torch.rand(out.shape, generator=gen, device=out.device)
    g = (out.float() - target) / out.shape[0]
    g[:, n_used:] = 0.0
    return g.to(torch.bfloat16)


def grad_agreement(got, ref, masks, torch):
    """(cosine, max |d| / max |ref|) over the real parameter slots, for
    all blocks together and for each block with a nonzero gradient."""
    def cos_rel(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        cos = float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))
        return cos, float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    keys = [k for k in ref if float((ref[k] * masks[k]).abs().max()) > 0]
    per = {k: cos_rel(got[k] * masks[k], ref[k] * masks[k]) for k in keys}
    overall = cos_rel(torch.cat([(got[k] * masks[k]).flatten() for k in keys]),
                      torch.cat([(ref[k] * masks[k]).flatten() for k in keys]))
    return overall, per


def profile_window(fn, torch, host=None, counts=None, ops=None):
    """(wall ms, device busy ms, {kernel name: device ms}) of one call of
    ``fn`` under torch.profiler; with ``host`` a dict, it also receives
    {host op: self CPU ms}, with ``counts`` {kernel name: launches}, with
    ``ops`` {host op: device ms of the kernels it launched itself}.  A
    ``record_function`` range also shows on the device's timeline (Adam's
    ``Optimizer.step#Adam.step`` spans its kernels); it is not a kernel,
    so neither the busy time nor the kernels count it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.key not in ranges:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count
        elif e.device_type == DeviceType.CPU:
            if host is not None:
                host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / 1e3
            if ops is not None and e.self_device_time_total > 0:
                ops[e.key] = ops.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return wall_ms, sum(by_name.values()), by_name


def top(by_name, n=8):
    """The ``n`` largest entries, names cut short (template arguments make them long)."""
    cut = {}
    for k, v in by_name.items():
        cut[k[:60]] = cut.get(k[:60], 0.0) + v
    return {k: round(v, 3) for k, v in sorted(cut.items(), key=lambda kv: -kv[1])[:n]}


def run_from(state, snap, gen, fn, torch):
    """Put ``snap`` back into ``state`` and ``gen``, call ``fn()`` (which
    returns a ``LossReport``) and return what it left: the report, the
    parameters, Adam's state and the generator's state."""
    from intrinsicnerf_tpu_torch.train.step import restore_state

    restore_state(state, snap, gen)
    report = fn()
    torch.cuda.synchronize()
    params = [p.detach().clone() for g in state.optimizer.param_groups for p in g["params"]]
    adam = [{k: v.clone() for k, v in state.optimizer.state[p].items()}
            for g in state.optimizer.param_groups for p in g["params"]]
    return {"report": report, "params": params, "adam": adam, "gen": gen.get_state(),
            "step": (state.step, int(state.step_t))}


def compare_runs(a, b, exact: bool, torch):
    """(agree, detail) of two ``run_from`` results: bitwise with ``exact``,
    else the total within GRAPH_TOTAL_RTOL and every parameter within
    GRAPH_PARAM_ATOL + GRAPH_PARAM_RTOL |ref|; the generator states and
    step counts always equal."""
    terms = {k: (float(x), float(y)) for k, x, y in
             zip(a["report"]._fields, a["report"], b["report"])}
    param_err = max(float((x - y).abs().max()) for x, y in zip(a["params"], b["params"]))
    same_gen = torch.equal(a["gen"], b["gen"]) and a["step"] == b["step"]
    if exact:
        agree = (all(torch.equal(x, y) for x, y in zip(a["report"], b["report"]))
                 and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
                 and all(torch.equal(x[k], y[k]) for x, y in zip(a["adam"], b["adam"]) for k in x))
    else:
        total_a, total_b = terms["total"]
        agree = (abs(total_a - total_b) <= GRAPH_TOTAL_RTOL * abs(total_b)
                 and all(torch.allclose(x, y, rtol=GRAPH_PARAM_RTOL, atol=GRAPH_PARAM_ATOL)
                         for x, y in zip(a["params"], b["params"])))
    max_term_rel = max(abs(x - y) / max(abs(y), 1e-12) for x, y in terms.values())
    return agree and same_gen, {"max_param_abs_diff": param_err, "max_term_rel_diff": max_term_rel,
                                "generator_and_step_equal": same_gen}


def graph_phase(torch, np, step_fn, state, pools, table, w_c, gen, card, phase="train_graph"):
    """``train_graph`` (or ``phase``): GRAPH_K eager steps twice from one state and
    generator state (bitwise or not), then GRAPH_K steps as one graph
    replay from the same state, held to the eager steps; the kernels of a
    profiled replay by name; eager and graphed ms per step."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.tools import bwd_passes
    from intrinsicnerf_tpu_torch.train.step import make_multi_step, restore_state, snapshot_state

    k = GRAPH_K
    w_c_t = torch.tensor(w_c, dtype=torch.float32, device=state.step_t.device)
    snap = snapshot_state(state, gen)

    def eager():
        for _ in range(k):
            report = step_fn(state, pools, table, w_c_t, gen)
        return report

    multi = make_multi_step(step_fn, k)

    def graphed():
        return multi(state, pools, table, w_c_t, gen)

    first = run_from(state, snap, gen, eager, torch)
    second = run_from(state, snap, gen, eager, torch)
    eager_bitwise, eager_detail = compare_runs(first, second, True, torch)
    counters = (fm.fused_mlp_forward, fm.fwd_weight_image, fm.fused_mlp_backward)
    for c in counters:
        c.launches = c.captured = 0
    t0 = time.perf_counter()
    g1 = run_from(state, snap, gen, graphed, torch)  # the capture, then its first replay
    capture_s = time.perf_counter() - t0
    eager_launches = [c.launches for c in counters]
    captured = [c.captured for c in counters]
    g2 = run_from(state, snap, gen, graphed, torch)  # a replay of the restored state
    agree1, detail1 = compare_runs(g1, first, eager_bitwise, torch)
    agree2, detail2 = compare_runs(g2, first, eager_bitwise, torch)

    # the device time of GRAPH_CALLS replays, by kernel name; the kernels of
    # one replay counted by name in a window of their own (a longer window
    # of the ScanNet step's replays lost a few records to the profiler)
    counts, ops = {}, {}
    restore_state(state, snap, gen)
    wall_ms, busy_ms, by_name = profile_window(
        lambda: [graphed() for _ in range(GRAPH_CALLS)], torch)
    n_steps = GRAPH_CALLS * k
    restore_state(state, snap, gen)
    profile_window(graphed, torch, counts=counts)

    def n_named(sub):  # launches in the replay
        return sum(v for name, v in counts.items() if sub in name)

    # per step, coarse + fine: each kernel of kernels 1 and 2 twice, kernel
    # 2's row sums four times (weights and biases)
    want = {name: 2 * k * n for name, n in REPLAY_KERNELS.items()}
    found = {name: n_named(name) for name in REPLAY_KERNELS}
    k1_ms = sum(v for name, v in by_name.items()
                if "fused_mlp_fwd_kernel" in name or "fwd_wimg_kernel" in name)
    k2_ms = sum(v for name, v in by_name.items()
                if any(sub in name for sub in bwd_passes.PASSES.values()))
    other = {name: v for name, v in by_name.items()
             if "fused_mlp_fwd_kernel" not in name and "fwd_wimg_kernel" not in name
             and not any(sub in name for sub in bwd_passes.PASSES.values())}

    # the same device work by host op, from one eager step
    profile_window(lambda: step_fn(state, pools, table, w_c_t, gen), torch, ops=ops)

    # ms per step: eager and graphed windows of GRAPH_CALLS x GRAPH_K steps
    def window_ms(fn):
        times = []
        for _ in range(3):
            restore_state(state, snap, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_CALLS):
                fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0) / (GRAPH_CALLS * k))
        return float(np.median(times)), times

    eager_ms, eager_times = window_ms(eager)
    graph_ms, graph_times = window_ms(graphed)
    t0 = time.perf_counter()
    graphed()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    restore_state(state, snap, gen)  # the state as this phase found it

    kernels_ok = found == want
    say(phase, k=k, eager_bitwise=eager_bitwise, eager_repeat=json.dumps(eager_detail),
        mode="bitwise" if eager_bitwise else json.dumps(
            {"total_rtol": GRAPH_TOTAL_RTOL, "param_atol": GRAPH_PARAM_ATOL,
             "param_rtol": GRAPH_PARAM_RTOL}),
        graph_vs_eager=json.dumps(detail1), replay_after_restore_vs_eager=json.dumps(detail2),
        capture_s=f"{capture_s:.3f}", capture_eager_launches=json.dumps(eager_launches),
        captured=json.dumps(captured), replay_kernels=json.dumps(found), want=json.dumps(want),
        eager_ms_per_step=f"{eager_ms:.3f}", graph_ms_per_step=f"{graph_ms:.3f}",
        eager_windows_ms=json.dumps([round(x, 3) for x in eager_times]),
        graph_windows_ms=json.dumps([round(x, 3) for x in graph_times]),
        replay_enqueue_ms=f"{enqueue_ms:.3f}", card=json.dumps(card))
    say("profile", path=f"{phase}_replay", replays=GRAPH_CALLS, steps=n_steps,
        wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}",
        busy_ms_per_step=f"{busy_ms / n_steps:.3f}",
        busy_over_graph_ms_per_step=f"{busy_ms / n_steps / graph_ms:.3f}",
        kernel1_ms_per_step=f"{k1_ms / n_steps:.3f}", kernel2_ms_per_step=f"{k2_ms / n_steps:.3f}",
        other_ms_per_step=f"{sum(other.values()) / n_steps:.3f}",
        other_top_kernels_ms_per_step=json.dumps({n: round(v / n_steps, 4) for n, v in
                                                  top(other, 15).items()}),
        eager_step_device_ms_by_op=json.dumps(top(ops, 20)), card=json.dumps(card),
        clocks=json.dumps(smi(CLOCKS)))
    if not (agree1 and agree2 and kernels_ok and captured == [2 * k] * 3
            and eager_launches == [2, 2, 2]):
        raise AssertionError(f"the graphed steps disagree with the eager steps or their kernels: "
                             f"{detail1} {detail2} {found} captured {captured} "
                             f"eager {eager_launches}")
    del multi
    torch.cuda.empty_cache()
    return {"eager_bitwise": eager_bitwise, "eager_ms": eager_ms, "graph_ms": graph_ms,
            "busy_share": busy_ms / wall_ms, "replay_kernels": {n: int(v) for n, v in found.items()},
            "kernel1_ms": k1_ms / n_steps, "kernel2_ms": k2_ms / n_steps,
            "image_ms": sum(v for name, v in by_name.items() if "fwd_wimg_kernel" in name) / n_steps,
            "other_ms": sum(other.values()) / n_steps,
            "other_by_kind": rest_by_kind(other, n_steps)}


def rest_by_kind(other, n_steps):
    """Device ms per step of the kernels outside kernels 1 and 2, by
    REST_KINDS (the rest under ``other``)."""
    out = {kind: 0.0 for kind, _ in REST_KINDS}
    out["other"] = 0.0
    for name, v in other.items():
        kind = next((k for k, subs in REST_KINDS if any(x in name for x in subs)), "other")
        out[kind] += v / n_steps
    return {k: round(v, 4) for k, v in out.items()}


def packed_phase(torch, np, dev, card, mcfg, tcfg, step_fn, pools, table, w_c, seed, phase,
                 start=0):
    """``phase``: the packed training state (``PackedMLP``, what
    ``create_train_state`` makes here) against the unpacked one
    (``IntrinsicMLP``), both from one seeded generator, the same draws and
    generator state: PACKED_STEPS graphed steps each (a one-step graph
    replayed once per step), the loss terms, the unpacked weights and
    Adam's unpacked moments held bitwise after every step, the first step
    and tensor that part named if any do.  Then both states' K-step
    replays profiled by kernel name in the same call (``graph_phase``):
    kernels 1 and 2 and the rest, by kind."""
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP
    from intrinsicnerf_tpu_torch.train.checkpoint import optimizer_state_dict
    from intrinsicnerf_tpu_torch.train.step import create_train_state, make_multi_step

    w_c_t = torch.tensor(w_c, dtype=torch.float32, device=dev)
    states, runs = {}, {}
    for packed in (True, False):
        st = create_train_state(mcfg, tcfg, device=dev, packed=packed,
                                generator=torch.Generator().manual_seed(seed))
        if isinstance(st.model_fine, PackedMLP) != packed:
            raise AssertionError(f"create_train_state(packed={packed}) made {st.model_fine}")
        st.step = start
        st.step_t.fill_(start)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        multi = make_multi_step(step_fn, 1)
        after = []
        for _ in range(PACKED_STEPS):
            rep = torch.stack(list(multi(st, pools, table, w_c_t, gen)))
            after.append(copy.deepcopy((rep, [m.state_dict() for m in (st.model_coarse,
                                                                      st.model_fine)],
                                           optimizer_state_dict(st)["state"])))
        torch.cuda.synchronize()
        states[packed], runs[packed] = (st, gen), after
        del multi

    def first_part():
        for i, ((rp, wp, ap), (ru, wu, au)) in enumerate(zip(runs[True], runs[False])):
            if not torch.equal(rp, ru):
                return [i + 1, "loss terms", float((rp - ru).abs().max())]
            for level, sp, su in zip(("coarse", "fine"), wp, wu):
                for k in su:
                    if not torch.equal(sp[k], su[k]):
                        return [i + 1, f"{level} {k}", float((sp[k] - su[k]).abs().max())]
            for j in au:
                for n in ("exp_avg", "exp_avg_sq"):
                    if not torch.equal(ap[j][n], au[j][n]):
                        return [i + 1, f"adam {j} {n}", float((ap[j][n] - au[j][n]).abs().max())]
        return None

    part = first_part()
    last = runs[True][-1][0]
    say(phase, steps=PACKED_STEPS, bitwise=part is None, first_part=json.dumps(part),
        total_after=json.dumps([float(f"{float(r[0][0]):.6g}") for r in runs[True]]),
        finite=bool(torch.isfinite(last).all()), card=json.dumps(card))
    del runs
    graphs = {}
    for packed, name in ((True, "packed"), (False, "unpacked")):
        st, gen = states[packed]
        graphs[name] = graph_phase(torch, np, step_fn, st, pools, table, w_c, gen, card,
                                   phase=f"{phase}_graph_{name}")
    split = {name: {k: (round(g[k], 4) if isinstance(g[k], float) else g[k]) for k in (
        "graph_ms", "eager_ms", "kernel1_ms", "image_ms", "kernel2_ms", "other_ms",
        "other_by_kind", "busy_share")} for name, g in graphs.items()}
    say(f"{phase}_split", per_step_ms=json.dumps(split),
        rest_saved_ms=f"{graphs['unpacked']['other_ms'] - graphs['packed']['other_ms']:.4f}",
        graph_saved_ms=f"{graphs['unpacked']['graph_ms'] - graphs['packed']['graph_ms']:.4f}",
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    if part is not None or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"the packed steps part from the unpacked steps at {part}")
    del states
    torch.cuda.empty_cache()
    return {"graphs": graphs}


def step_vs_host(torch, state, sl, draws, table, w_c, mcfg, rcfg, tcfg, h, w, dev,
                 phase="step_vs_plain"):
    """One training step on the batch ``sl`` with the fixed ``draws``, from
    copies of ``state``'s models: on the card (kernels 1 and 2, each
    launched twice) against the plain versions on the host, the loss
    terms within STEP_REL and each level's gradient within cosine
    STEP_COS."""
    from intrinsicnerf_tpu_torch.data.samplers import RayBatch
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.train.step import TrainState, make_train_step

    def run_on(device):
        mc = copy.deepcopy(state.model_coarse).to(device)
        mf = copy.deepcopy(state.model_fine).to(device)
        opt = torch.optim.Adam(list(mc.parameters()) + list(mf.parameters()), lr=tcfg.lrate,
                               capturable=torch.device(device).type == "cuda")
        st = TrainState(step=state.step, model_coarse=mc, model_fine=mf, optimizer=opt)
        b = RayBatch(*(x.to(device) if torch.is_tensor(x) else x for x in sl))
        dr = {k: (v.to(device) if v is not None else None) for k, v in draws.items()}
        tab = type(table)(*(x.to(device) if torch.is_tensor(x) else x for x in table))
        fn = make_train_step(mcfg, rcfg, tcfg, h, w, sample_fn=lambda g_, p_, s_: b,
                             noise_fn=lambda g_, n_: dr)
        rep = fn(st, None, tab, w_c, None)
        grads = [torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
                 for m in (mc, mf)]
        return {k: float(v) for k, v in rep._asdict().items()}, grads

    fm.fused_mlp_forward.launches = fm.fused_mlp_backward.launches = 0
    fm.fwd_weight_image.launches = 0
    rep_k, grads_k = run_on(dev)
    torch.cuda.synchronize()
    slice_launches = (fm.fused_mlp_forward.launches, fm.fused_mlp_backward.launches,
                      fm.fwd_weight_image.launches)
    rep_p, grads_p = run_on("cpu")
    rel = {k: abs(rep_k[k] - rep_p[k]) / max(abs(rep_p[k]), 1e-7) for k in rep_p}
    cos = [float(a @ b / (a.norm() * b.norm())) for a, b in zip(grads_k, grads_p)]
    say(phase, pairs=SLICE_PAIRS, launches=json.dumps(slice_launches),
        rel_err=json.dumps({k: float(f"{v:.3g}") for k, v in rel.items()}), tol=STEP_REL,
        grad_cos=json.dumps({"coarse": round(cos[0], 7), "fine": round(cos[1], 7)}),
        cos_tol=STEP_COS)
    if slice_launches != (2, 2, 2) or max(rel.values()) > STEP_REL or min(cos) < STEP_COS:
        raise AssertionError(f"the step on the card disagrees with the plain step: {rel} {cos}")


def train_phases(torch, np, fc, mcfg, dev, card, macs, view_rays):
    """Kernel 2 against its plain version, then the training path: timed
    steps, a fixed-batch run, the step against the plain versions on the
    host, and a profiled step.  Returns what the kernels line needs."""
    from intrinsicnerf_tpu_torch.cluster.assign import map_drgb, table_from_numpy
    from intrinsicnerf_tpu_torch.core.rays import create_rays
    from intrinsicnerf_tpu_torch.core.sampling import stratified_z_vals
    from intrinsicnerf_tpu_torch.data.samplers import RayBatch, sample_ray_pairs
    from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.render.pipeline import draw_train_noise
    from intrinsicnerf_tpu_torch.tools import bwd_passes
    from intrinsicnerf_tpu_torch.train.step import DataPools, create_train_state, make_train_step

    rcfg, tcfg = fc.render, fc.train
    n_rays = 2 * tcfg.n_rays  # pixels and their neighbours
    n_coarse_pts = n_rays * rcfg.n_coarse
    n_fine_pts = n_rays * (rcfg.n_coarse + rcfg.n_importance)

    # the backward's multiply-adds per point, counted on the network's own
    # layers (tools/bwd_passes.py:backward_macs)
    probe = IntrinsicMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(5))
    work = bwd_passes.backward_macs(probe)
    bwd_macs = sum(work.values())
    say("work", bwd_macs_per_point=bwd_macs, **work)

    # ---- kernel 2 vs plain at the step's shapes ----
    ops = probe.fused_operands(mcfg)
    masks = fm.packed_grad_masks(dict(probe.named_parameters()), mcfg)
    r0 = view_rays[0, :n_rays]
    def in8_for(n_samples):
        z = stratified_z_vals(r0[:, 6:7], r0[:, 7:8], n_samples)
        return fm.build_in8(r0[:, None, 0:3] + r0[:, None, 3:6] * z[..., None], r0[:, 8:11])
    in8_fine = in8_for(rcfg.n_coarse + rcfg.n_importance)
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = (("coarse_step", in8_for(rcfg.n_coarse)), ("fine_step", in8_fine),
             ("ragged", in8_fine[:100_003]))
    bwd_timing, bwd_max_err, fwd_step_ms = {}, 0.0, {}
    n_used = 8 + mcfg.num_semantic_classes
    for label, in8 in cases:
        n = in8.shape[0]
        fwd_step_ms[label] = cuda_ms(lambda: fm.fused_mlp_forward(ops, in8), 5, torch)
        g = loss_cotangent(fm.fused_mlp_forward(ops, in8), n_used, gen, torch)
        got = fm.fused_mlp_backward(ops, in8, g)
        again = fm.fused_mlp_backward(ops, in8, g)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(got[k], again[k]) for k in got)
        ref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
        (cos, rel), per = grad_agreement(got, ref, masks, torch)
        worst_cos = min(per.items(), key=lambda kv: kv[1][0])
        worst_rel = max(per.items(), key=lambda kv: kv[1][1])
        bwd_max_err = max(bwd_max_err, max(float(((got[k] - ref[k]) * masks[k]).abs().max())
                                           for k in got))
        flops = 2.0 * bwd_macs * n
        # points and cotangent in; bf16 weights, fp32 biases in; fp32 gradients out
        nbytes = n * (8 * 4 + 128 * 2) + ops.wbuf.numel() * (2 + 4) + ops.bbuf.numel() * (4 + 4)
        bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
        k_ms = cuda_ms(lambda: fm.fused_mlp_backward(ops, in8, g), 5, torch)
        p_ms = cuda_ms(lambda: fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g), 2, torch)
        # each pass's device time (profiled) beside its own bound
        passes = bwd_passes.pass_times(lambda: fm.fused_mlp_backward(ops, in8, g), 5)
        pass_bounds = bwd_passes.pass_bounds(n, work, fm.backward_splits(n))
        pass_ms = {p: round(passes[p], 4) for p in bwd_passes.PASSES}
        pass_bound = {p: [round(b[0], 4), b[1]] for p, b in pass_bounds.items()}
        # the arena's own floor: written once and read once at the memory's rate
        arena_ms = 1e3 * 2 * n * bwd_passes.ARENA_BYTES / PEAK_BYTES
        bwd_timing[label] = dict(points=n, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, arena_floor_ms=arena_ms, pass_ms=pass_ms,
                                 pass_bound_ms=pass_bound)
        say("bwd_kernel_vs_plain", shape=label, points=n, bitwise_repeat=bitwise,
            cos=f"{cos:.7f}", rel_err=f"{rel:.3g}",
            worst_block_cos=json.dumps([worst_cos[0], round(worst_cos[1][0], 7)]),
            worst_block_rel=json.dumps([worst_rel[0], float(f"{worst_rel[1][1]:.3g}")]),
            tol=json.dumps({"cos": BWD_COS, "rel": BWD_REL}), ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            arena_floor_ms=f"{arena_ms:.4f}", pass_ms=json.dumps(pass_ms),
            pass_bound_ms=json.dumps(pass_bound), achieved_tflops=f"{flops / k_ms / 1e9:.1f}",
            fwd_kernel_ms=f"{fwd_step_ms[label]:.4f}",
            fwd_bound_ms=f"{1e3 * 2.0 * macs * n / PEAK_BF16_FLOPS:.4f}", card=json.dumps(card))
        ok = (bitwise and cos > BWD_COS and rel <= BWD_REL
              and all(c > BWD_COS and r <= BWD_REL for c, r in per.values())
              and all(bool(torch.isfinite(x).all()) for x in got.values()))
        if not ok:
            raise AssertionError(f"kernel 2 disagrees with its plain version at {label}: "
                                 f"bitwise={bitwise} overall={(cos, rel)} per block={per}")
    del probe, ops, cases, in8_fine, got, again, ref
    torch.cuda.empty_cache()

    # ---- the training path ----
    rng = np.random.default_rng(7)
    c2w = np.tile(np.eye(4, dtype=np.float32), (N_VIEWS, 1, 1))
    for i in range(N_VIEWS):  # distinct poses: turned about y, moved along x and z
        a = 0.3 * i
        c2w[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[i, :3, 3] = [0.4 * i - 0.6, -0.2, -1.0 - 0.1 * i]
    c2w = torch.from_numpy(c2w).to(dev)
    pool_rays = create_rays(c2w, H, W, W / 2, W / 2, (W - 1) / 2, (H - 1) / 2, *fc.depth_range)
    n_cls = mcfg.num_semantic_classes
    pools = DataPools(
        rays=pool_rays,
        rgb=torch.from_numpy(rng.uniform(size=(N_VIEWS, H * W, 3)).astype(np.float32)).to(dev),
        semantic=torch.from_numpy(rng.integers(0, n_cls + 1, size=(N_VIEWS, H * W))).to(dev),
        mask_ids=torch.ones(N_VIEWS, dtype=torch.int32, device=dev))
    per_class = []
    for _ in range(n_cls):  # 8 centres, 2,048 anchors per class around them
        centers = rng.uniform(0.05, 1.0, size=(8, 3)).astype(np.float32)
        links = rng.integers(0, 8, size=2048)
        anchors = map_drgb(centers[links]) + rng.normal(size=(2048, 3)).astype(np.float32) * 0.02
        per_class.append((anchors, links, centers))
    table = table_from_numpy(per_class, 2048, device=dev)
    w_c = 0.1
    state = create_train_state(mcfg, tcfg, device=dev, generator=torch.Generator().manual_seed(8))
    step_fn = make_train_step(mcfg, rcfg, tcfg, H, W)
    gen = torch.Generator(device=dev).manual_seed(9)
    before = [p.detach().clone() for p in state.model_coarse.parameters()]
    for _ in range(WARM_STEPS):
        step_fn(state, pools, table, w_c, gen)
    torch.cuda.synchronize()

    fm.fused_mlp_forward.launches = 0
    fm.fused_mlp_backward.launches = 0
    fm.fwd_weight_image.launches = 0
    step_ms, host_ms, reports = [], [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        reports.append(step_fn(state, pools, table, w_c, gen))
        host_ms.append(1e3 * (time.perf_counter() - t0))  # the step's work enqueued
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"fwd": fm.fused_mlp_forward.launches, "bwd": fm.fused_mlp_backward.launches,
                "fwd_image": fm.fwd_weight_image.launches}
    want = 2 * TIMED_STEPS  # coarse + fine per step, each forward with its weight image
    if launches != {"fwd": want, "bwd": want, "fwd_image": want}:
        raise AssertionError(f"{TIMED_STEPS} training steps launched {launches}, want {want} each")
    bad = [(i, k) for i, r in enumerate(reports) for k, v in r._asdict().items()
           if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"loss terms not finite: {bad[:5]}")
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(state.model_coarse.parameters(), before))
    if moved != len(before):
        raise AssertionError(f"only {moved} of {len(before)} coarse parameters moved")
    median = float(np.median(step_ms))
    step_bound_ms = 1e3 * 2.0 * (macs * (n_coarse_pts + n_fine_pts)
                                 + bwd_macs * (n_coarse_pts + n_fine_pts)) / PEAK_BF16_FLOPS
    bwd_ms = bwd_timing["coarse_step"]["ms"] + bwd_timing["fine_step"]["ms"]
    fwd_ms = fwd_step_ms["coarse_step"] + fwd_step_ms["fine_step"]
    say("train_step", rays=n_rays, points=f"{n_coarse_pts}+{n_fine_pts}",
        launches=json.dumps(launches), median_ms_per_step=f"{median:.3f}",
        steps_ms=json.dumps([round(x, 3) for x in step_ms]),
        median_host_enqueue_ms=f"{float(np.median(host_ms)):.3f}",
        steps_per_s=f"{1e3 / median:.2f}", rays_per_s=f"{n_rays * 1e3 / median:.0f}",
        kernel_ms_per_step=json.dumps({"fwd": round(fwd_ms, 3), "bwd": round(bwd_ms, 3)}),
        bound_ms_per_step=f"{step_bound_ms:.3f}",
        last=json.dumps({k: float(f"{float(v):.5g}") for k, v in reports[-1]._asdict().items()}),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))

    # K steps per call: eager against one CUDA graph replay
    graph = graph_phase(torch, np, step_fn, state, pools, table, w_c, gen, card)
    # the packed state against the unpacked one, bitwise; both replays' split
    packed = packed_phase(torch, np, dev, card, mcfg, tcfg, step_fn, pools, table, w_c, 8,
                          "train_packed")

    # one fixed batch with fixed draws: the generator is reseeded before each step
    totals = []
    for _ in range(FIXED_STEPS):
        totals.append(float(step_fn(state, pools, table, w_c, gen.manual_seed(10)).total))
    say("train_fixed_batch", steps=FIXED_STEPS, first_total=f"{totals[0]:.6f}",
        last_total=f"{totals[-1]:.6f}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {totals}")

    # ---- the step on a 64-pair slice: the card against the plain versions on the host ----
    big = sample_ray_pairs(gen.manual_seed(11), pools.rays, pools.rgb, H, W, tcfg.n_rays,
                           sem_pool=pools.semantic, mask_ids=pools.mask_ids)
    idx = torch.cat([torch.arange(SLICE_PAIRS), tcfg.n_rays + torch.arange(SLICE_PAIRS)]).to(dev)
    sl = RayBatch(rays=big.rays[idx], rgb=big.rgb[idx], depth=None, semantic=big.semantic[idx],
                  sem_flag=big.sem_flag, image_idx=big.image_idx)
    draws = draw_train_noise(2 * SLICE_PAIRS, rcfg, gen.manual_seed(12), dev)

    step_vs_host(torch, state, sl, draws, table, w_c, mcfg, rcfg, tcfg, H, W, dev)

    # where a step's device time goes
    bwd_before = fm.fused_mlp_backward.launches
    wall_ms, busy_ms, by_name = profile_window(
        lambda: step_fn(state, pools, table, w_c, gen), torch)
    bwd_profiled = fm.fused_mlp_backward.launches - bwd_before
    k1 = sum(v for k, v in by_name.items() if "fused_mlp_fwd_kernel" in k)
    # kernel 2's passes by name: a rename must not report 0 ms in silence
    k2_passes = {p: sum(v for k, v in by_name.items() if sub in k)
                 for p, sub in bwd_passes.PASSES.items()}
    k2 = sum(k2_passes.values())
    if bwd_profiled and min(k2_passes.values()) <= 0.0:
        raise AssertionError(f"the profiled step launched kernel 2 {bwd_profiled} times but its "
                             f"passes {k2_passes} "
                             f"were not all found among {sorted(by_name)}")
    say("profile", path="train_step", wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", busy_over_median_step=f"{busy_ms / median:.3f}",
        kernel1_share=f"{k1 / busy_ms:.3f}",
        kernel2_share=f"{k2 / busy_ms:.3f}", kernel1_ms=f"{k1:.3f}", kernel2_ms=f"{k2:.3f}",
        kernel2_pass_ms=json.dumps({p: round(v, 3) for p, v in k2_passes.items()}),
        top_kernels_ms=json.dumps(top(by_name)), card=json.dumps(card),
        clocks=json.dumps(smi(CLOCKS)))
    return {"bwd_timing": bwd_timing, "bwd_max_err": bwd_max_err, "launches": launches,
            "fwd_step_ms": fwd_step_ms, "graph": graph, "packed": packed}


def probe_phases(torch, np, dev, card, build_log):
    """Kernel 3's build (registers, spills), its weight image and every
    case against their plain versions, then the probe's own path (the
    sweep of ``tools/fwd_probe.py``) with its launches counted."""
    from intrinsicnerf_tpu_torch.ops import build
    from intrinsicnerf_tpu_torch.ops import fwd_probe as fp
    from intrinsicnerf_tpu_torch.tools import fwd_probe as probe_cli

    # every instantiation's registers and spills, from the build's -Xptxas -v
    usage = probe_cli.instantiations(build.ptxas_usage(build_log))
    registers = {k: u["registers"] for k, u in sorted(usage.items())}
    spills = {k: u["spill_stores"] + u["spill_loads"] for k, u in sorted(usage.items())}
    c7519 = "C7519" in build_log
    say("probe_build", instantiations=len(usage), registers=json.dumps(registers),
        spill_bytes=json.dumps(spills), c7519=c7519)
    if len(usage) != len(fp.VARIANTS) * len(fp.TILES) or any(spills.values()) or c7519:
        raise AssertionError(f"kernel 3's build: {len(usage)} instantiations, spills {spills}, "
                             f"C7519 {c7519}")

    # the weight image on the card against the plain version's bytes
    for n_layers in (1, 8, fp.MAX_LAYERS):
        _, ops = fp.probe_inputs(n_layers, n=1, device=dev)
        want = fp.probe_weight_image_plain(ops.wbuf, n_layers).view(torch.int16)
        img_same = (torch.equal(fp.fwd_probe_image(ops.wbuf, n_layers).view(torch.int16), want)
                    and torch.equal(ops.wimg.view(torch.int16), want))
        if not img_same:
            raise AssertionError(f"kernel 3's weight image at {n_layers} layers differs from "
                                 "the plain one")
    img_ms = cuda_ms(lambda: fp.fwd_probe_image(ops.wbuf, n_layers), 20, torch)
    img_plain_ms = cuda_ms(lambda: fp.probe_weight_image_plain(ops.wbuf, n_layers), 5, torch)
    img_bound_ms = 1e3 * 2 * 2 * ops.wbuf.numel() / PEAK_BYTES  # bf16 read once, written once
    image = dict(ms=img_ms, plain_ms=img_plain_ms, bound_ms=img_bound_ms, bound_by="bytes")
    say("probe_image_vs_plain", layers=json.dumps([1, 8, fp.MAX_LAYERS]), bitwise=True,
        elems=ops.wbuf.numel(), ms=f"{img_ms:.4f}", plain_ms=f"{img_plain_ms:.4f}",
        bound_ms=f"{img_bound_ms:.4f}", bound_by="bytes", card=json.dumps(card))

    # every case of the sweep (variants, tiles, layer counts, fp32 output),
    # the layer counts at the 128-point tile, then ragged point counts
    layer_counts = (1, 2, 4, 8, fp.MAX_LAYERS)
    cases = ([(n_layers, v, tile, PROBE_N, out) for n_layers, v, tile, out in probe_cli.SWEEP]
             + [(n_layers, "full", 128, PROBE_N, torch.bfloat16)
                for n_layers in layer_counts if n_layers != 8]
             + [(8, "full", tile, PROBE_RAGGED, torch.bfloat16) for tile in fp.TILES])
    max_err, timing = 0.0, {}
    for n_layers, variant, tile, n, out in cases:
        in8, ops = fp.probe_inputs(n_layers, n=n, bias_scale=0.1, device=dev)
        got = fp.fwd_probe(in8, ops, variant, tile, out)
        again = fp.fwd_probe(in8, ops, variant, tile, out)
        torch.cuda.synchronize()
        bitwise = torch.equal(got.view(torch.int16 if out == torch.bfloat16 else torch.int32),
                              again.view(torch.int16 if out == torch.bfloat16 else torch.int32))
        ref = fp.fwd_probe_plain(in8, ops, variant, out)
        d = (got.float() - ref.float()).abs().max().item()
        rel = d / max(ref.float().abs().max().item(), 1.0)
        max_err = max(max_err, d)
        k_ms = cuda_ms(lambda: fp.fwd_probe(in8, ops, variant, tile, out), 10, torch)
        p_ms = cuda_ms(lambda: fp.fwd_probe_plain(in8, ops, variant, out), 3, torch)
        flops, _ = fp.probe_work(n, n_layers, out)
        bound_ms, bound_by = probe_cli.bound(n, n_layers, out)
        say("probe_vs_plain", layers=n_layers, variant=variant, tile=tile, points=n,
            out="f32" if out == torch.float32 else "bf16", bitwise_repeat=bitwise,
            rel_err=f"{rel:.3g}", tol=PROBE_TOL, ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            achieved_tflops=f"{flops / k_ms / 1e9:.1f}", card=json.dumps(card))
        if not (bitwise and rel < PROBE_TOL and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"kernel 3 disagrees with its plain version at "
                                 f"{(n_layers, variant, tile, n, out)}: {rel}, bitwise {bitwise}")
        timing[(n_layers, variant, tile, n, out)] = dict(ms=k_ms, plain_ms=p_ms,
                                                         bound_ms=bound_ms, bound_by=bound_by)
        del in8, ops, got, again, ref

    # the cost of one more layer at each tile, against one library layer
    per_layer = {tile: probe_cli.layer_slope(
        {n_layers: timing[(n_layers, "full", tile, PROBE_N, torch.bfloat16)]["ms"]
         for n_layers in layer_counts}) for tile in fp.TILES}
    layer_ms = probe_cli.cublas_layer_ms(PROBE_N, dev, 20)
    say("probe_per_layer", points=PROBE_N, ms_per_layer=json.dumps(per_layer),
        torch_matmul_layer_ms=f"{layer_ms:.4f}",
        layer_bound_ms=f"{1e3 * 2.0 * PROBE_N * fp.W * fp.W / PEAK_BF16_FLOPS:.4f}",
        card=json.dumps(card))

    # the probe's own path: its CLI's sweep, launches counted
    fp.fwd_probe.launches = fp.fwd_probe_image.launches = 0
    sweep = [probe_cli.run_case(n_layers, v, tile, out, PROBE_N, dev, 20)
             for n_layers, v, tile, out in probe_cli.SWEEP]
    launches, image_launches = fp.fwd_probe.launches, fp.fwd_probe_image.launches
    for r in sweep:
        say("probe_sweep", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in r.items()},
            card=json.dumps(card))
    want = len(probe_cli.SWEEP) * (4 + 20)  # warm-up and timed calls per case
    want_images = len(probe_cli.SWEEP)  # one set of weights per case
    say("probe_sweep", launches=launches, want=want, image_launches=image_launches,
        image_want=want_images)
    if (launches, image_launches) != (want, want_images):
        raise AssertionError(f"the probe sweep launched kernel 3 {launches} times (want {want}) "
                             f"and its image {image_launches} times (want {want_images})")
    torch.cuda.empty_cache()
    main = timing[(8, "full", 64, PROBE_N, torch.bfloat16)]
    return {"max_err": max_err, "launches": launches, "image_launches": image_launches,
            "ms_tile128": timing[(8, "full", 128, PROBE_N, torch.bfloat16)]["ms"],
            "ms_per_layer": per_layer, "library_ms_per_layer": layer_ms,
            "registers": registers, "spill_bytes": spills, "image": image, **main}


def read_scalars(path):
    """{name: {step: value}} from a trainer's ``scalars.csv``."""
    import csv

    out = {}
    with open(path) as f:
        for step, name, val in csv.reader(f):
            out.setdefault(name, {})[int(step)] = float(val)
    return out


def scene_phases(torch, np, dev, card, spc=1, exact=True, other=None):
    """The scene trainer on a synthetic room at the Replica config with
    ``steps_per_call`` ``spc``: an evaluation, ``SCENE_STEPS`` steps with
    two rebuilds, two checkpoints and an evaluation; with ``spc`` > 1 a
    graphed block after the last rebuild held to the same steps run
    eagerly on the new table (bitwise with ``exact``, else the graph
    bounds); then a resume in a second trainer.  With ``other``, an
    earlier run's result, it prints how far the two runs' parameters
    after ``SCENE_STEPS`` lie apart."""
    import shutil

    from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split, load_replica
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.tools.synthetic_replica import write_synthetic_replica
    from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer, saved_steps
    from intrinsicnerf_tpu_torch.train.prepare import prepare_replica_bundle
    from intrinsicnerf_tpu_torch.train.step import snapshot_state
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    phase = "scene" if spc == 1 else f"scene_k{spc}"
    counters = {"fwd": fm.fused_mlp_forward, "bwd": fm.fused_mlp_backward,
                "image": fm.fwd_weight_image}

    def zero_counts():
        for c in counters.values():
            c.launches = c.captured = 0

    def counts(trainer):
        """(eager launches, launches recorded into graphs, launches in all
        runs: eager + replays x launches per replay) per wrapper."""
        eager = {k: c.launches for k, c in counters.items()}
        captured = {k: c.captured for k, c in counters.items()}
        replays = trainer.multi_step.replays if trainer.multi_step is not None else 0
        per_replay = {k: 2 * spc if replays else 0 for k in counters}  # coarse + fine a step
        total = {k: eager[k] + replays * per_replay[k] for k in counters}
        return eager, captured, per_replay, replays, total

    work = os.path.join(ROOT, "logs", f"chip_smoke_{phase}")
    shutil.rmtree(work, ignore_errors=True)
    data_dir, save_dir = os.path.join(work, "data"), os.path.join(work, "run")
    t0 = time.perf_counter()
    report = write_synthetic_replica(data_dir, SCENE_FRAMES, W, H)
    data_s = time.perf_counter() - t0
    overrides = {"experiment.dataset_dir": data_dir, "experiment.save_dir": save_dir,
                 "train.N_iters": SCENE_STEPS, "train.steps_per_call": spc,
                 **{f"logging.{k}": v for k, v in SCENE_CADENCE.items()}}
    cfg = from_yaml(CONFIG, overrides)
    train_ids, test_ids = default_replica_split(SCENE_FRAMES, SCENE_SPLIT)
    data = load_replica(data_dir, train_ids, test_ids, img_h=cfg.experiment.height,
                        img_w=cfg.experiment.width)
    bundle = prepare_replica_bundle(cfg, data, device=dev)
    n_train, n_test = len(train_ids), len(test_ids)
    say(f"{phase}_data", tool=json.dumps(report), seconds=f"{data_s:.1f}", train_views=n_train,
        test_views=n_test, classes=bundle.num_valid_classes, view=f"{H}x{W}")

    steps = []  # (step, enqueue ms, call ms, did periodic work), one per call

    def hook(done, t_start, t_enqueued, did_work):
        torch.cuda.synchronize()
        steps.append((done, 1e3 * (t_enqueued - t_start),
                      1e3 * (time.perf_counter() - t_start), did_work))
        if done % SCENE_CADENCE["step_vis_train"] == 0:
            rebuilds.append(dict(trainer.last_rebuild))

    rebuilds = []
    trainer = Trainer(cfg, bundle, seed=0, device=dev)
    trainer.step_hook = hook
    zero_counts()
    t0 = time.perf_counter()
    m0 = trainer.evaluate(0)
    eval_s = time.perf_counter() - t0
    report_last = trainer.fit(progress=False)
    torch.cuda.synchronize()
    eager, captured, per_replay, replays, total = counts(trainer)

    # after the last rebuild, a replay reads the table copied in: one block
    # as a replay against the same steps run eagerly, on the new table and
    # on an empty one
    table_check = None
    if spc > 1:
        st, gen = trainer.state, trainer.generator
        snap = snapshot_state(st, gen)
        trainer._w_c_t.fill_(trainer.w_c)
        empty = empty_cluster_table(trainer.n_table_classes, device=dev)

        def eager_block(table):
            def fn():
                for _ in range(spc):
                    rep = trainer.step_fn(st, bundle.pools, table, trainer._w_c_t, gen)
                return rep
            return fn

        graphed = run_from(st, snap, gen, lambda: trainer.multi_step(
            st, bundle.pools, trainer.table, trainer._w_c_t, gen), torch)
        on_new = run_from(st, snap, gen, eager_block(trainer.table), torch)
        on_empty = run_from(st, snap, gen, eager_block(empty), torch)
        run_from(st, snap, gen, lambda: None, torch)  # the state as the fit left it
        agree_new, detail_new = compare_runs(graphed, on_new, exact, torch)
        agree_empty, detail_empty = compare_runs(graphed, on_empty, exact, torch)
        table_check = {"graph_vs_eager_new_table": detail_new,
                       "graph_vs_eager_empty_table": detail_empty}
        say(f"{phase}_table", w_c=trainer.w_c, mode="bitwise" if exact else "bounds",
            **{k: json.dumps(v) for k, v in table_check.items()})
        if not agree_new or agree_empty:
            raise AssertionError(f"a replay after the rebuild does not read the new table: "
                                 f"{table_check}")

    state_after = [p.detach().clone() for m in (trainer.state.model_coarse,
                                                trainer.state.model_fine) for p in m.parameters()]
    opt_after = copy.deepcopy(trainer.state.optimizer.state_dict())
    table_after = [t.clone() for t in trainer.table[:4]]
    anneal_after = (trainer.w_c, trainer.b_f)
    gen_after = trainer.generator.get_state()
    ck_dir = os.path.join(work, "ckpt_timing")
    ck = Checkpointer(ck_dir)
    t0 = time.perf_counter()
    ck.save(trainer.state, SCENE_STEPS, trainer.generator)
    copy_ms = 1e3 * (time.perf_counter() - t0)
    ck.wait()
    save_ms = 1e3 * (time.perf_counter() - t0)
    ck.close()
    trainer.close()

    # ---- checks on the run ----
    sc = read_scalars(os.path.join(save_dir, "tfb_logs", "scalars.csv"))
    view_rays = bundle.h_scaled * bundle.w_scaled
    chunks = math.ceil(view_rays / min(cfg.chunk, view_rays))
    views = n_test + 2 * n_train + n_test  # eval(0), two rebuilds, eval at the end
    n_logs = SCENE_STEPS // SCENE_CADENCE["step_log_tfb"]
    probes = n_logs if trainer.logger.writer is not None else 0  # sigma probe: 2 launches
    # eager training steps: all of them, or the one a capture warms up with
    eager_steps = SCENE_STEPS - replays * spc + (1 if replays else 0)
    want = {"fwd": 2 * eager_steps + 2 * chunks * views + 2 * probes, "bwd": 2 * eager_steps,
            # kernel 1's weight image: one per forward of a step; a render
            # builds one per model at each set of weights and keeps it for its
            # chunks (eval at 0, then the sigma probes, or the rebuilds without them)
            "image": 2 * eager_steps + 2 * (1 + (probes or 2))}
    want_captured = {k: (2 * spc if spc > 1 else 0) for k in counters}
    if (eager, captured) != (want, want_captured) or (spc > 1 and replays != SCENE_STEPS // spc):
        raise AssertionError(f"the {phase} run launched {eager} (want {want}), recorded "
                             f"{captured} into graphs (want {want_captured}), {replays} replays")
    img = sc["Train/Loss/img_fine"]
    log_steps = sorted(img)
    first, last = np.mean([img[s] for s in log_steps[:2]]), np.mean([img[s] for s in log_steps[-2:]])
    cluster = sc["Train/Loss/reflect_cluster"]
    w_c_eff = sc["Train/w_c_eff"]
    first_rebuild = SCENE_CADENCE["step_vis_train"]
    before = [s for s in log_steps if s <= first_rebuild]
    after = [s for s in log_steps if s > first_rebuild]
    m_end = {k[5:]: v[SCENE_STEPS] for k, v in sc.items()
             if k.startswith("Test/") and SCENE_STEPS in v}
    test_dir = os.path.join(save_dir, "test_render", f"step_{SCENE_STEPS:06d}")
    missing = [f"{name}_{i:03d}.png" for name in SAVE_VIEW_FILES for i in range(n_test)
               if not os.path.exists(os.path.join(test_dir, f"{name}_{i:03d}.png"))]
    rebuild_dirs = [os.path.join(save_dir, "train_render", f"step_{s:06d}")
                    for s in (first_rebuild, SCENE_STEPS)]
    missing += [d for d in rebuild_dirs
                if not all(os.path.exists(os.path.join(d, f)) for f in
                           ("cluster/clusters.json", "c000.png", "edit000.png", "rgb_000.png"))]
    # every cadence lands where one step per call puts it
    landed = {"logs": log_steps,
              "checkpoints": saved_steps(os.path.join(save_dir, "checkpoints")),
              "evals": sorted(sc.get("Test/psnr", {})), "rebuild_calls": [
                  r for r, *_ in steps if r % SCENE_CADENCE["step_vis_train"] == 0]}
    def every(cadence):
        return list(range(SCENE_CADENCE[cadence], SCENE_STEPS + 1, SCENE_CADENCE[cadence]))

    want_landed = {"logs": every("step_log_tfb"), "checkpoints": every("step_save_ckpt"),
                   "evals": [0] + every("step_val"), "rebuild_calls": every("step_vis_train")}
    plain = [x for x in steps if not x[3]]
    median_ms = float(np.median([x[2] for x in plain])) / spc  # per step
    say(f"{phase}_fit", steps=SCENE_STEPS, steps_per_call=spc, launches=json.dumps(eager),
        want=json.dumps(want), captured=json.dumps(captured), replays=replays,
        launches_with_replays=json.dumps(total), landed=json.dumps(landed),
        img_fine_first=f"{first:.5f}", img_fine_last=f"{last:.5f}",
        cluster_mse=json.dumps({s: round(cluster[s], 6) for s in log_steps}),
        w_c_eff=json.dumps({s: w_c_eff[s] for s in log_steps}),
        eval_0=json.dumps({k: round(v, 4) for k, v in m0.items()
                           if k in ("psnr", "miou", "total_acc")}),
        eval_end=json.dumps({k: round(v, 4) for k, v in m_end.items()
                             if k in ("psnr", "miou", "total_acc")}),
        missing_files=json.dumps(missing))
    finite = all(math.isfinite(m[k]) for m in (m0, m_end) for k in ("psnr", "miou", "total_acc"))
    # the cluster term as the loss weighs it: off until the first rebuild
    term = {s: w_c_eff[s] * cluster[s] for s in log_steps}
    ok = (last < first and all(term[s] == 0.0 for s in before)
          and all(term[s] > 0.0 for s in after) and landed == want_landed
          and len(rebuilds) == 2 and finite and m_end["psnr"] > m0["psnr"] and not missing
          and all(math.isfinite(float(v)) for v in report_last))
    if not ok:
        raise AssertionError(f"the {phase} run failed a check (see the {phase}_fit line)")
    if other is not None:
        diff = max(float((a - b).abs().max()) for a, b in zip(state_after, other["params"]))
        say(f"{phase}_vs_scene", params_bitwise=all(
            torch.equal(a, b) for a, b in zip(state_after, other["params"])),
            max_param_abs_diff=diff, psnr_end=json.dumps([m_end["psnr"], other["psnr_end"]]))
    say(f"{phase}_time", steps_per_call=spc, median_ms_per_plain_step=f"{median_ms:.3f}",
        median_host_enqueue_ms_per_step=f"{float(np.median([x[1] for x in plain])) / spc:.3f}",
        plain_calls=len(plain), steps_per_s=f"{1e3 / median_ms:.2f}",
        rebuilds=json.dumps([{k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in r.items()} for r in rebuilds]),
        eval_s=f"{eval_s:.3f}", eval_views=n_test,
        checkpoint_host_copy_ms=f"{copy_ms:.2f}", checkpoint_save_ms=f"{save_ms:.2f}",
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))

    # ---- resume in a second trainer ----
    trainer2 = Trainer(cfg, bundle, seed=0, device=dev)
    step = trainer2.maybe_resume()
    params2 = [p.detach() for m in (trainer2.state.model_coarse, trainer2.state.model_fine)
               for p in m.parameters()]
    opt2 = trainer2.state.optimizer.state_dict()

    def same(a, b):
        if torch.is_tensor(a):
            return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    exact_resume = {
        "step": step == SCENE_STEPS == int(trainer2.state.step_t),
        "params": same(state_after, params2),
        "adam": same(opt_after["state"], opt2["state"]),
        "palette": same(table_after, list(trainer2.table[:4])),
        "anneal": (trainer2.w_c, trainer2.b_f) == anneal_after,
        "generator": same(gen_after, trainer2.generator.get_state()),
    }
    zero_counts()
    rep = trainer2.fit(n_iters=SCENE_STEPS + SCENE_MORE, progress=False)
    torch.cuda.synchronize()
    _, _, _, replays2, total2 = counts(trainer2)
    # where a step of the loop goes, on the device and on the host
    host = {}
    wall_ms, busy_ms, by_name = profile_window(
        lambda: trainer2.step_fn(trainer2.state, trainer2.bundle.pools, trainer2.table,
                                 trainer2.w_c, trainer2.generator), torch, host)
    say("profile", path=f"{phase}_step", wall_ms=f"{wall_ms:.2f}",
        device_busy_ms=f"{busy_ms:.2f}", busy_share=f"{busy_ms / wall_ms:.3f}",
        top_kernels_ms=json.dumps(top(by_name, 5)),
        host_cpu_ms=f"{sum(host.values()):.2f}", top_host_ops_ms=json.dumps(top(host, 10)),
        card=json.dumps(card))
    trainer2.close()
    # the eager step that warms a capture adds one step's launches
    more_want = 2 * SCENE_MORE + (2 if replays2 else 0)
    say(f"{phase}_resume", exact=json.dumps(exact_resume), more_steps=SCENE_MORE,
        bwd_launches_with_replays=total2["bwd"], want=more_want, replays=replays2,
        global_step=trainer2.global_step, last_total=f"{float(rep.total):.5f}")
    if not (all(exact_resume.values()) and total2["bwd"] == more_want
            and (spc == 1 or replays2 == SCENE_MORE // spc)
            and math.isfinite(float(rep.total))
            and trainer2.global_step == SCENE_STEPS + SCENE_MORE):
        raise AssertionError(f"the {phase} resume failed: {exact_resume}, {total2} launches")
    return {"launches": total, "eager_launches": eager, "replays": replays,
            "median_ms": median_ms, "table_check": table_check, "params": state_after,
            "psnr_end": m_end["psnr"], "data_dir": data_dir, "save_dir": save_dir}


def edit_phase(torch, np, dev, card, save_dir):
    """``edit``: the editing session (``tools/editing.py``) on the scene
    run's last rebuild: its renders and palette, the cluster search on
    the card.  The cluster ids equal a host session's on every frame, at
    least two clusters are in use on a frame, and after the same recolour
    the composed edits agree within 1/255."""
    from intrinsicnerf_tpu_torch.tools.editing import EditSession

    renders = sorted(d for d in glob.glob(os.path.join(save_dir, "train_render", "step_*"))
                     if os.path.exists(os.path.join(d, "cluster", "clusters.json")))
    img_dir = renders[-1]
    card_s = EditSession(img_dir, os.path.join(img_dir, "cluster"), device=dev)
    host_s = EditSession(img_dir, os.path.join(img_dir, "cluster"), device="cpu")
    ids = card_s.frame_ids()
    load_ms, same_ids, in_use = [], True, []
    for i in ids:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fc = card_s.load_frame(i)
        load_ms.append(1e3 * (time.perf_counter() - t0))
        fh = host_s.load_frame(i)
        same_ids = same_ids and np.array_equal(fc["cluster"], fh["cluster"])
        used = fc["cluster"] >= 0
        in_use.append(len(set(zip(fc["label"][used].tolist(), fc["cluster"][used].tolist()))))
    # recolour the frame's commonest cluster in both sessions
    f0 = card_s.load_frame(ids[0])
    pairs, counts = np.unique(np.stack([f0["label"].ravel(), f0["cluster"].ravel()]), axis=1,
                              return_counts=True)
    keep = pairs[1] >= 0
    sem, cid = (int(x) for x in pairs[:, keep][:, np.argmax(counts[keep])])
    for sess in (card_s, host_s):
        sess.set_cluster_color(sem, cid, [0.1, 0.8, 0.3])
    diff = float(np.abs(card_s.compose(ids[0]) - host_s.compose(ids[0])).max())
    say("edit", render_dir=json.dumps(os.path.relpath(img_dir, ROOT)), frames=len(ids),
        cluster_ids_equal_host=same_ids, clusters_in_use=json.dumps(in_use),
        recoloured=json.dumps([sem, cid]), compose_max_abs_diff=f"{diff:.3g}", tol=f"{1 / 255:.3g}",
        ms_per_load_frame=f"{float(np.median(load_ms)):.2f}",
        load_frame_ms=json.dumps([round(x, 2) for x in load_ms]), card=json.dumps(card))
    if not (same_ids and max(in_use) >= 2 and diff <= 1 / 255):
        raise AssertionError(f"the edit session on the card: ids equal {same_ids}, clusters in "
                             f"use {in_use}, compose differs by {diff}")
    return {"ms_per_load_frame": float(np.median(load_ms)), "frames": len(ids)}


# ------------------------------------------------------------ data parallelism

DP_SEED, DP_STEPS = 5, 8  # the graphed steps held bitwise, one replay each
DP_CLI_STEPS, DP_CLI_MORE, DP_K = 100, 20, 10
DP_CADENCE = {"step_log_tfb": 50, "step_save_ckpt": 100, "step_vis_train": 100,
              "step_val": 100}
DP_ROUNDS = 3  # timing rounds of (plain, group, group, plain) windows


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def collective_counters():
    from intrinsicnerf_tpu_torch.parallel import mesh

    return {"reduce_grads": mesh.reduce_grads, "reduce_terms": mesh.reduce_terms,
            "all_gather_rows": mesh.all_gather_rows}


def zero_collectives():
    for c in collective_counters().values():
        c.launches = c.captured = 0


def data_parallel_phase(torch, np, dev, card, room_dir):
    """``data_parallel``: a one-rank NCCL group in this process, started as
    ``torchrun`` starts a rank (its environment variables), then on the
    Replica config's packed state:

    - ``dp_step``: the data-parallel trainer's step (gradients and loss
      terms all-reduced inside the CUDA graph) against the plain
      trainer's from one seed, DP_STEPS graphed steps each (a one-step
      graph replayed per step), the report, the weights and Adam's
      moments bitwise after every step; the collectives' calls per
      replay, and both steps' graphed ms in turns, with the NCCL kernels'
      device time in a profiled window;
    - ``dp_view``: one 320x240 view through the split render, bitwise
      ``render_views``;
    - ``dp_cli``: the scene CLI's trainer with ``--data_parallel``
      (DP_CLI_STEPS steps at DP_K per call, a rebuild and an evaluation
      at the end), then a second process (its own one-rank group) that
      resumes exactly and trains DP_CLI_MORE more steps.

    The group is destroyed at the end and the variables put back."""
    import torch.distributed as dist

    from intrinsicnerf_tpu_torch import train_scene
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split, load_replica
    from intrinsicnerf_tpu_torch.parallel.distributed import backend_for, initialize_distributed
    from intrinsicnerf_tpu_torch.parallel.mesh import make_group
    from intrinsicnerf_tpu_torch.train.checkpoint import optimizer_state_dict
    from intrinsicnerf_tpu_torch.train.prepare import prepare_replica_bundle
    from intrinsicnerf_tpu_torch.train.step import make_multi_step, restore_state, snapshot_state
    from intrinsicnerf_tpu_torch.train.trainer import Trainer, render_views

    import shutil

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    rank_world = initialize_distributed(device=dev)
    group = make_group(dev)
    init_s = time.perf_counter() - t0
    graphed = dev.type == "cuda"  # on the host a block of steps is a loop
    say("dp_group", backend=group.backend, rank_world=json.dumps(rank_world),
        device=json.dumps(str(group.device)),
        nccl=json.dumps(torch.cuda.nccl.version() if graphed else None),
        torch=torch.__version__, init_s=f"{init_s:.2f}", card=json.dumps(card))
    if (group.backend, group.world, rank_world) != (backend_for(dev), 1, (0, 1)):
        raise AssertionError(f"a one-rank NCCL group was asked for, got {group}")

    work = os.path.join(ROOT, "logs", "chip_smoke_data_parallel")
    shutil.rmtree(work, ignore_errors=True)

    def cfg_for(name, **more):
        return from_yaml(CONFIG, {"experiment.dataset_dir": room_dir,
                                  "experiment.save_dir": os.path.join(work, name), **more})

    cfg = cfg_for("plain")
    train_ids, test_ids = default_replica_split(SCENE_FRAMES, SCENE_SPLIT)
    data = load_replica(room_dir, train_ids, test_ids, img_h=cfg.experiment.height,
                        img_w=cfg.experiment.width)
    bundle = prepare_replica_bundle(cfg, data, device=dev)
    trainers = {"plain": Trainer(cfg, bundle, seed=DP_SEED, device=dev),
                "group": Trainer(cfg_for("group"), bundle, seed=DP_SEED, device=dev,
                                 group=group)}

    # ---- the step: DP_STEPS graphed steps each, held after every step
    runs, counts, launches = {}, {}, {}
    for name, t in trainers.items():
        zero_launches()
        zero_collectives()
        multi = make_multi_step(t.step_fn, 1)
        after = []
        for _ in range(DP_STEPS):
            rep = torch.stack(list(multi(t.state, t.bundle.pools, t.table, t._w_c_t,
                                         t.generator)))
            after.append(copy.deepcopy((rep, [m.state_dict() for m in (
                t.state.model_coarse, t.state.model_fine)], optimizer_state_dict(t.state)["state"])))
        torch.cuda.synchronize()
        runs[name] = after
        counts[name] = {k: [c.launches, c.captured] for k, c in collective_counters().items()}
        eager = {k: c.launches for k, c in launch_counters().items()}
        launches[name] = {k: eager[k] + multi.replays * c.captured
                          for k, c in launch_counters().items()}

    def first_part():
        for i, ((rp, wp, ap), (rg, wg, ag)) in enumerate(zip(runs["plain"], runs["group"])):
            if not torch.equal(rp, rg):
                return [i + 1, "loss terms", float((rp - rg).abs().max())]
            for level, sp, sg in zip(("coarse", "fine"), wp, wg):
                for k in sp:
                    if not torch.equal(sp[k], sg[k]):
                        return [i + 1, f"{level} {k}", float((sp[k] - sg[k]).abs().max())]
            for j in ap:
                for n in ("exp_avg", "exp_avg_sq"):
                    if not torch.equal(ap[j][n], ag[j][n]):
                        return [i + 1, f"adam {j} {n}", float((ap[j][n] - ag[j][n]).abs().max())]
        return None

    part = first_part()
    # each replay of the one-step graph: one gradient and one loss-term
    # all-reduce; the capture's warm-up step ran each once more, eagerly
    per_replay = {k: counts["group"][k][1] for k in ("reduce_grads", "reduce_terms")}
    totals = [float(r[0][0]) for r in runs["group"]]
    del runs

    # graphed ms per step, DP_STEPS-step graphs, in turns from one snapshot each
    multis = {name: make_multi_step(t.step_fn, GRAPH_K) for name, t in trainers.items()}
    snaps = {name: snapshot_state(t.state, t.generator) for name, t in trainers.items()}

    def call(name):
        t = trainers[name]
        return multis[name](t.state, t.bundle.pools, t.table, t._w_c_t, t.generator)

    zero_collectives()
    for name in trainers:
        call(name)  # the capture
    torch.cuda.synchronize()
    captured_k = {k: c.captured for k, c in collective_counters().items()}
    windows = {"plain": [], "group": []}
    for _ in range(DP_ROUNDS):
        for name in ("plain", "group", "group", "plain"):
            t = trainers[name]
            restore_state(t.state, snaps[name], t.generator)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_CALLS):
                call(name)
            torch.cuda.synchronize()
            windows[name].append(1e3 * (time.perf_counter() - t0) / (GRAPH_CALLS * GRAPH_K))
    t = trainers["group"]
    restore_state(t.state, snaps["group"], t.generator)
    wall_ms, busy_ms, by_name = profile_window(lambda: [call("group") for _ in range(GRAPH_CALLS)],
                                               torch)
    nccl = {k: v for k, v in by_name.items() if "nccl" in k.lower()}
    n_steps = GRAPH_CALLS * GRAPH_K
    ms = {name: float(np.median(w)) for name, w in windows.items()}
    say("dp_step", steps=DP_STEPS, bitwise=part is None, first_part=json.dumps(part),
        total_after=json.dumps([float(f"{x:.6g}") for x in totals]),
        collective_calls_per_replay=json.dumps(per_replay),
        collective_counts_eager_captured=json.dumps(counts["group"]),
        captured_per_graph_of_k=json.dumps({"k": GRAPH_K, **captured_k}),
        launches=json.dumps(launches), graph_ms_per_step=json.dumps(ms),
        windows_ms=json.dumps({k: [round(x, 4) for x in v] for k, v in windows.items()}),
        group_minus_plain_ms=f"{ms['group'] - ms['plain']:.4f}",
        nccl_kernels_ms_per_step=json.dumps({k: round(v / n_steps, 5) for k, v in nccl.items()}),
        nccl_ms_per_step=f"{sum(nccl.values()) / n_steps:.5f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", card=json.dumps(card),
        clocks=json.dumps(smi(CLOCKS)))
    want_calls = {"reduce_grads": int(graphed), "reduce_terms": int(graphed)}
    if (part is not None or per_replay != want_calls
            or {k: captured_k[k] for k in want_calls} != {k: GRAPH_K * graphed
                                                           for k in want_calls}
            or launches["group"] != launches["plain"] or not all(map(math.isfinite, totals))):
        raise AssertionError(f"the data-parallel step: first differing part {part}, collectives "
                             f"per replay {per_replay} (want {want_calls}), per {GRAPH_K}-step "
                             f"graph {captured_k}, launches {launches}")
    del multis, snaps

    # ---- the view: split over the group and gathered, against render_views
    t = trainers["group"]
    rays = bundle.rays_test[:1]
    zero_launches()
    zero_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    view = next(t.render_views(rays))
    torch.cuda.synchronize()
    view_ms = 1e3 * (time.perf_counter() - t0)
    view_launches = {k: c.launches for k, c in launch_counters().items()}
    gathers = collective_counters()["all_gather_rows"].launches
    chunk = min(cfg.chunk, bundle.h_scaled * bundle.w_scaled)  # the trainer's render chunk
    plain = next(render_views(t.state.model_coarse, t.state.model_fine, t.mcfg, cfg.render, rays,
                              bundle.h_scaled, bundle.w_scaled, chunk, device=dev))
    same = sorted(k for k in plain if np.array_equal(view[k], plain[k]))
    view_times = {"split": [], "plain": []}  # in turns: plain, split, split, plain

    def one_view(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(t.render_views(rays) if name == "split" else render_views(
            t.state.model_coarse, t.state.model_fine, t.mcfg, cfg.render, rays, bundle.h_scaled,
            bundle.w_scaled, chunk, device=dev))
        torch.cuda.synchronize()
        view_times[name].append(1e3 * (time.perf_counter() - t0))

    for _ in range(DP_ROUNDS):
        for name in ("plain", "split", "split", "plain"):
            one_view(name)
    view_med = {k: float(np.median(v)) for k, v in view_times.items()}
    say("dp_view", view=f"{bundle.h_scaled}x{bundle.w_scaled}", bitwise=same == sorted(plain),
        maps=json.dumps(sorted(plain)), same=json.dumps(same), launches=json.dumps(view_launches),
        gathers=gathers, first_ms=f"{view_ms:.2f}", median_ms=json.dumps(view_med),
        views_ms=json.dumps({k: [round(x, 2) for x in v] for k, v in view_times.items()}),
        mean_acc=f"{float(view['acc'].mean()):.4f}", card=json.dumps(card))
    n_chunks = math.ceil(bundle.h_scaled * bundle.w_scaled / chunk)
    content = (plain["rgb"].max() > 0 and plain["depth"].max() > 0
               and plain["acc"].mean() > VIEW_ACC_FLOOR)  # two empty views agree too
    if (same != sorted(plain) or not content or view_launches["fwd"] != 2 * n_chunks
            or gathers == 0):
        raise AssertionError(f"the split view differs from render_views in {sorted(plain)} - "
                             f"{same}, is empty (mean acc {float(plain['acc'].mean()):.4f} <= "
                             f"{VIEW_ACC_FLOOR}), or its launches {view_launches} / gathers "
                             f"{gathers}")
    for tr in trainers.values():
        tr.close()
    del trainers, t
    torch.cuda.empty_cache()

    # ---- the CLI at one rank, then a resume in a second process
    cfg_path = scene_yaml(CONFIG, os.path.join(work, "cli.yaml"), {
        "experiment.dataset_dir": room_dir, "experiment.save_dir": os.path.join(work, "cli"),
        "train.N_iters": DP_CLI_STEPS, "train.steps_per_call": DP_K,
        **{f"logging.{k}": v for k, v in DP_CADENCE.items()}})
    cli_args = ["--config_file", cfg_path, "--device", dev.type, "--data_parallel",
                "--total_frames", str(SCENE_FRAMES), "--split_step", str(SCENE_SPLIT)]
    zero_launches()
    zero_collectives()
    t0 = time.perf_counter()
    ccfg, cbundle, trainer = train_scene.build_trainer(train_scene.parse_args(cli_args))
    with trainer:
        trainer.maybe_resume()
        report = trainer.fit(progress=False)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    _, _, cli_launches, replays = run_launches(trainer)
    cli_counts = {k: [c.launches, c.captured] for k, c in collective_counters().items()}
    save_dir = ccfg.experiment.save_dir
    ck = torch.load(os.path.join(save_dir, "checkpoints", f"{DP_CLI_STEPS:06d}.ckpt"),
                    map_location="cpu", weights_only=False)
    sc = read_scalars(os.path.join(save_dir, "tfb_logs", "scalars.csv"))
    psnr = sc.get("Test/psnr", {}).get(DP_CLI_STEPS, float("nan"))
    rebuilt = os.path.exists(os.path.join(save_dir, "train_render", f"step_{DP_CLI_STEPS:06d}",
                                          "cluster", "clusters.json"))
    say("dp_cli", steps=DP_CLI_STEPS, steps_per_call=DP_K, seconds=f"{cli_s:.1f}",
        replays=replays, launches_with_replays=json.dumps(cli_launches),
        collective_counts_eager_captured=json.dumps(cli_counts), rebuilt=rebuilt,
        eval_psnr=f"{psnr:.3f}", last_total=f"{float(report.total):.5f}",
        generator_states=len(ck.get("generator_states", [])), card=json.dumps(card))
    want_counts = [1, DP_K] if graphed else [DP_CLI_STEPS, 0]
    if not (replays == (DP_CLI_STEPS // DP_K if graphed else 0)
            and cli_counts["reduce_grads"] == cli_counts["reduce_terms"] == want_counts
            and rebuilt and math.isfinite(psnr)
            and math.isfinite(float(report.total)) and len(ck["generator_states"]) == 1):
        raise AssertionError("the data-parallel CLI run failed a check (see the dp_cli line)")
    ref = resume_state(trainer)
    del trainer, cbundle
    torch.cuda.empty_cache()
    os.environ["MASTER_PORT"] = str(free_port())  # the second process's own one-rank group
    resume, resume_s = resume_check(torch, ref, work, "intrinsicnerf_tpu_torch.train_scene",
                                    cli_args, DP_CLI_STEPS + DP_CLI_MORE, DP_K, graphed)
    say("dp_resume", seconds=f"{resume_s:.1f}", **{k: json.dumps(v) for k, v in resume.items()})

    dist.destroy_process_group()
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    parts = {"step": launches["group"], "view": view_launches, "cli": cli_launches}
    return {"launches": {k: sum(p[k] for p in parts.values()) for k in ("fwd", "bwd", "image")},
            "parts": parts, "graph_ms": ms, "nccl_ms": sum(nccl.values()) / n_steps,
            "per_replay": per_replay, "view_ms": view_med}


# ------------------------------------------------------- the other scene data


def scene_yaml(src, path, changes):
    """A copy of the scene config ``src`` at ``path`` with the dotted keys
    of ``changes`` set (``{"experiment.dataset_dir": ...}``)."""
    import yaml

    d = yaml.safe_load(open(src))
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        node = d
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def launch_counters():
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    return {"fwd": fm.fused_mlp_forward, "bwd": fm.fused_mlp_backward,
            "image": fm.fwd_weight_image}


def zero_launches():
    for c in launch_counters().values():
        c.launches = c.captured = 0


def run_launches(trainer=None):
    """(eager launches, recorded into graphs, all: eager + replays x
    recorded) per wrapper, after a run of ``trainer``."""
    counters = launch_counters()
    eager = {k: c.launches for k, c in counters.items()}
    captured = {k: c.captured for k, c in counters.items()}
    replays = trainer.multi_step.replays if trainer is not None and trainer.multi_step else 0
    return eager, captured, {k: eager[k] + replays * captured[k] for k in counters}, replays


def semantic_model(torch, c, dev, seed):
    """The scene network (8x256, the skip, view directions, the fused
    kernels) at ``c`` semantic classes from seeded weights, and its config."""
    from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig

    mcfg = MLPConfig(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=c,
                     compute_dtype=torch.bfloat16, use_fused_kernel=True)
    return IntrinsicMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(seed)), mcfg


def kernel_checks(torch, np, model, mcfg, rays, rcfg, card, seed, phase):
    """Kernels 1 and 2 on ``model``'s weights at a step's coarse and fine
    calls (``rays`` at n_coarse and n_coarse + n_importance samples)
    against their plain versions: kernel 1 per output slice within
    KERNEL_TOL, its columns past 8 + C exactly 0; kernel 2 within its
    bounds overall and per block, each bitwise across two launches.  At
    C > 0 the semantic blocks (the output block's columns 8 to 8 + C
    included) are among the blocks held; at C = 0 (an object) their
    gradient is exactly 0.  Times, and bounds at the network's own
    multiply-adds (its reference weights)."""
    from intrinsicnerf_tpu_torch.core.sampling import stratified_z_vals
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.tools import bwd_passes

    c = mcfg.num_semantic_classes if mcfg.enable_semantic else 0
    sem_blocks = ("w_m1", "b_m1", "w_m2", "b_m2")
    macs = network_macs(model)
    bwd_macs = sum(bwd_passes.backward_macs(model).values())
    ops = model.fused_operands(mcfg)
    masks = fm.packed_grad_masks(model.state_dict(), mcfg)
    gen = torch.Generator(device=rays.device).manual_seed(seed)
    slices = {"sigma": (0, 1), "albedo": (1, 4), "shading": (4, 5), "residual": (5, 8),
              **({"semantic": (8, 8 + c)} if c else {})}
    out = {"c": c, "macs": macs, "bwd_macs": bwd_macs, "max_fwd_err": 0.0, "max_bwd_err": 0.0}
    for label, n_samples in (("coarse", rcfg.n_coarse), ("fine", rcfg.n_coarse + rcfg.n_importance)):
        z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], n_samples)
        in8 = fm.build_in8(rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None], rays[:, 8:11])
        n = in8.shape[0]
        got = fm.fused_mlp_forward(ops, in8)
        again = fm.fused_mlp_forward(ops, in8)
        torch.cuda.synchronize()
        fwd_bitwise = torch.equal(got.view(torch.int16), again.view(torch.int16))
        zero_cols = bool((got[:, 8 + c:] == 0).all())
        ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8)
        errs = {k: (got[:, a:b].float() - ref[:, a:b].float()).abs().max().item()
                / max(ref[:, a:b].float().abs().max().item(), 1.0) for k, (a, b) in slices.items()}
        fwd_err = (got[:, :8 + c].float() - ref[:, :8 + c].float()).abs().max().item()
        g = loss_cotangent(got, 8 + c, gen, torch)
        bwd = fm.fused_mlp_backward(ops, in8, g)
        bwd2 = fm.fused_mlp_backward(ops, in8, g)
        torch.cuda.synchronize()
        bwd_bitwise = all(torch.equal(bwd[k], bwd2[k]) for k in bwd)
        bref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
        (cos, rel), per = grad_agreement(bwd, bref, masks, torch)
        bwd_err = max(float(((bwd[k] - bref[k]) * masks[k]).abs().max()) for k in bwd)
        if c:
            sem_ok = set(sem_blocks) <= set(per)
            sem = {k: [round(per[k][0], 7), float(f"{per[k][1]:.3g}")] for k in sem_blocks}
        else:
            # no gradient through the zero semantic blocks, and the mask
            # projection gives the shared output bias's none of it (b_m2)
            sem = max([float(bwd[k].abs().max()) for k in sem_blocks[:3]]
                      + [float((bwd[k] * masks[k]).abs().max()) for k in sem_blocks])
            sem_ok = sem == 0.0
        f_flops, f_bytes = fused_work(n, macs, ops.wbuf.numel(), ops.bbuf.numel())
        b_flops = 2.0 * bwd_macs * n
        b_bytes = n * (8 * 4 + 128 * 2) + ops.wbuf.numel() * (2 + 4) + ops.bbuf.numel() * (4 + 4)
        bounds = {}
        for part, (flops, nbytes) in (("fwd", (f_flops, f_bytes)), ("bwd", (b_flops, b_bytes))):
            by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
            bounds[part] = (1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES), by)
        row = {
            "points": n,
            "fwd": dict(ms=cuda_ms(lambda: fm.fused_mlp_forward(ops, in8), 5, torch),
                        plain_ms=cuda_ms(lambda: fm.fused_mlp_forward_plain(ops.packed, ops.pe,
                                                                            in8), 2, torch),
                        bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1],
                        max_abs_err=fwd_err),
            "bwd": dict(ms=cuda_ms(lambda: fm.fused_mlp_backward(ops, in8, g), 5, torch),
                        plain_ms=cuda_ms(lambda: fm.fused_mlp_backward_plain(
                            ops.packed, ops.pe, in8, g), 2, torch),
                        bound_ms=bounds["bwd"][0], bound_by=bounds["bwd"][1],
                        max_abs_err=bwd_err)}
        out[label] = row
        out["max_fwd_err"] = max(out["max_fwd_err"], fwd_err)
        out["max_bwd_err"] = max(out["max_bwd_err"], bwd_err)
        worst = min(per.items(), key=lambda kv: kv[1][0])
        say(phase, classes=c, call=label, points=n, fwd_bitwise_repeat=fwd_bitwise,
            fwd_rel_err=json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}),
            columns_past_8_plus_c_zero=zero_cols, bwd_bitwise_repeat=bwd_bitwise,
            bwd_cos=f"{cos:.7f}", bwd_rel_err=f"{rel:.3g}", semantic_blocks=json.dumps(sem),
            worst_block_cos=json.dumps([worst[0], round(worst[1][0], 7)]),
            tol=json.dumps({"fwd": KERNEL_TOL, "cos": BWD_COS, "rel": BWD_REL}),
            macs_per_point=json.dumps({"fwd": macs, "bwd": bwd_macs}),
            **{f"{part}_{k}": f"{row[part][k]:.4f}" for part in ("fwd", "bwd")
               for k in ("ms", "plain_ms", "bound_ms")}, card=json.dumps(card))
        ok = (fwd_bitwise and zero_cols and all(e < KERNEL_TOL for e in errs.values())
              and bwd_bitwise and sem_ok and cos > BWD_COS and rel <= BWD_REL
              and all(cc > BWD_COS and r <= BWD_REL for cc, r in per.values())
              and bool(torch.isfinite(got.float()).all()))
        if not ok:
            raise AssertionError(f"kernels 1 and 2 disagree with their plain versions at C = {c}, "
                                 f"the {label} call: {errs} {(cos, rel)} {per} {sem}")
        del in8, got, again, ref, g, bwd, bwd2, bref
    torch.cuda.empty_cache()
    return out


def view_vs_plain(torch, np, mc, mf, mcfg, rcfg, rays, out, seed, phase):
    """``out`` (a view rendered through the kernels) against the plain
    versions on the host on SUBSET of its rays (``rays [n, 11]``, seeded):
    the mean |d| / max(|plain|, 1) of rgb, depth and albedo, and of the
    semantic logits (the subset rendered on the card) where the model has
    them, each within VIEW_TOL.  The plain render must have content: some
    colour, depth and opacity, so that two empty views cannot agree."""
    from intrinsicnerf_tpu_torch.render.pipeline import render_rays_chunked

    idx = torch.randperm(rays.shape[0], generator=torch.Generator().manual_seed(seed))[:SUBSET]
    sub = rays[idx.to(rays.device)]
    with torch.no_grad():
        ref = render_rays_chunked(copy.deepcopy(mc).to("cpu"), copy.deepcopy(mf).to("cpu"), mcfg,
                                  sub.cpu(), rcfg, SUBSET).fine
        kern = (render_rays_chunked(mc, mf, mcfg, sub, rcfg, SUBSET).fine
                if mcfg.enable_semantic else None)
    flat = idx.numpy()
    pairs = {"rgb": (out["rgb"].reshape(-1, 3)[flat], ref.rgb.numpy()),
             "depth": (out["depth"].reshape(-1)[flat], ref.depth.numpy()),
             "albedo": (out["albedo"].reshape(-1, 3)[flat], ref.albedo.numpy())}
    if kern is not None:
        pairs["sem_logits"] = (kern.sem_logits.float().cpu().numpy(), ref.sem_logits.numpy())
    errs = {k: float(np.mean(np.abs(a - b)) / max(np.abs(b).max(), 1.0))
            for k, (a, b) in pairs.items()}
    content = {"rgb_max": float(ref.rgb.max()), "depth_max": float(ref.depth.max()),
               "acc_mean": float(ref.acc.mean())}
    say(phase, rays=SUBSET, mean_rel_err=json.dumps(errs), tol=VIEW_TOL,
        plain_content=json.dumps({k: round(v, 5) for k, v in content.items()}),
        content_floor=json.dumps({"acc_mean": VIEW_ACC_FLOOR}))
    if not (all(e <= VIEW_TOL for e in errs.values()) and content["rgb_max"] > 0.0
            and content["depth_max"] > 0.0 and content["acc_mean"] > VIEW_ACC_FLOOR):
        raise AssertionError(f"{phase}: the view against the plain version {errs}, "
                             f"the plain view's content {content}")
    return errs


def scannet_data_phase(torch, np, dev, card, room_dir):
    """``scannet_data``: the scene phases' room written as a ScanNet scan
    (``tools/synthetic_replica.py:write_scannet_from_replica``: 1296x968
    frames, raw label ids and their tsv, poses, intrinsics) under
    ``logs/chip_smoke_scannet/``, loaded by the CLI's loader at a copy of
    ``configs/scene/scannet_template.yaml`` with only the data paths, the
    run's length and the cadences changed, and its bundle on the card."""
    import shutil

    from intrinsicnerf_tpu_torch import train_scene
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.tools.synthetic_replica import (
        SCANNET_SIZE, write_scannet_from_replica)

    work = os.path.join(ROOT, "logs", "chip_smoke_scannet")
    shutil.rmtree(work, ignore_errors=True)
    scan_dir = os.path.join(work, "scan")
    t0 = time.perf_counter()
    frames = write_scannet_from_replica(room_dir, scan_dir, SCANNET_SCENE)
    write_s = time.perf_counter() - t0
    cfg_path = scene_yaml(SCANNET_CONFIG, os.path.join(work, "scannet.yaml"), {
        "experiment.dataset_dir": scan_dir, "experiment.scene_name": SCANNET_SCENE,
        "experiment.save_dir": os.path.join(work, "run"), "train.N_iters": SCANNET_STEPS,
        **{f"logging.{k}": v for k, v in SCANNET_CADENCE.items()}})
    cfg = from_yaml(cfg_path)
    m, r, e = cfg.mlp, cfg.render, cfg.experiment
    got = ((m.depth, m.width, tuple(m.skips), m.use_viewdirs, m.use_fused_kernel),
           (cfg.train.n_rays, r.n_coarse, r.n_importance, r.perturb, r.raw_noise_std),
           (e.width, e.height, e.nyu_mode, e.enable_semantic, e.enable_depth), cfg.chunk)
    if got != SCANNET_WANT:
        raise AssertionError(f"{SCANNET_CONFIG} no longer sets the ScanNet configuration: {got}")
    args = train_scene.parse_args(["--config_file", cfg_path, "--device", dev.type])
    t0 = time.perf_counter()
    data = train_scene.build_dataset(cfg, args)
    bundle = train_scene.prepare_bundle(cfg, data, dev)
    load_s = time.perf_counter() - t0
    split = [len(data.train_ids), len(data.test_ids)]
    k = data.intrinsics
    say("scannet_data", frames=frames, written_s=f"{write_s:.1f}", load_seconds=f"{load_s:.1f}",
        frame=json.dumps(list(SCANNET_SIZE)),
        h=bundle.h, w=bundle.w, classes=bundle.num_valid_classes,
        nyu40_ids=json.dumps(data.semantic_classes.tolist()), train_test=json.dumps(split),
        fx_fy_cx_cy=json.dumps([round(float(x), 4) for x in (k[0, 0], k[1, 1], k[0, 2], k[1, 2])]),
        config=os.path.relpath(SCANNET_CONFIG, ROOT))
    if ((bundle.h, bundle.w) != (cfg.experiment.height, cfg.experiment.width)
            or split != [4, 4] or bundle.num_valid_classes < 2):
        raise AssertionError(f"the ScanNet scan loaded at {bundle.h}x{bundle.w}, split {split}, "
                             f"{bundle.num_valid_classes} classes")
    return {"work": work, "scan_dir": scan_dir, "cfg_path": cfg_path, "cfg": cfg,
            "bundle": bundle}


def scannet_step_phase(torch, np, dev, card, sd):
    """``scannet_step``: the ScanNet step (512 pairs from the scan's pools,
    64 + 128 samples, the scan's C classes, depth on) 3 + 20 times eagerly,
    its kernels by name in a profiled step, a 64-pair slice against the
    plain versions on the host, kernels 1 and 2 at the step's calls at
    this C and at C = 40 and 13 against their plain versions, and GRAPH_K
    steps as one replay against eager steps."""
    from intrinsicnerf_tpu_torch.data.samplers import RayBatch
    from intrinsicnerf_tpu_torch.render.pipeline import draw_train_noise
    from intrinsicnerf_tpu_torch.tools import bwd_passes
    from intrinsicnerf_tpu_torch.train.step import create_train_state, make_train_step

    cfg, bundle = sd["cfg"], sd["bundle"]
    pools = bundle.pools
    c = bundle.num_valid_classes
    mcfg = dataclasses.replace(cfg.mlp, num_semantic_classes=c)
    rcfg, tcfg = cfg.render, cfg.train
    h, w = bundle.h, bundle.w
    state = create_train_state(mcfg, tcfg, device=dev, generator=torch.Generator().manual_seed(30))
    step_fn = make_train_step(mcfg, rcfg, tcfg, h, w)
    gen = torch.Generator(device=dev).manual_seed(31)
    table = one_class_table(np, dev, 32, n_classes=c)
    w_c = 0.1
    for _ in range(WARM_STEPS):
        step_fn(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in state.model_fine.parameters()]
    zero_launches()
    step_ms, host_ms, reports = [], [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        reports.append(step_fn(state, pools, table, w_c, gen))
        host_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = run_launches()[0]
    bad = [(i, k) for i, r in enumerate(reports) for k, v in r._asdict().items()
           if not math.isfinite(float(v))]
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(state.model_fine.parameters(), before))
    named = {}
    wall_ms, busy_ms, by_name = profile_window(
        lambda: step_fn(state, pools, table, w_c, gen), torch, counts=named)
    found = {k: sum(v for name, v in named.items() if k in name) for k in REPLAY_KERNELS}
    want_named = {k: 2 * v for k, v in REPLAY_KERNELS.items()}
    k1 = sum(v for k, v in by_name.items() if "fused_mlp_fwd_kernel" in k)
    k2 = sum(v for k, v in by_name.items() if any(s in k for s in bwd_passes.PASSES.values()))
    median = float(np.median(step_ms))
    n_rays = 2 * tcfg.n_rays
    points = n_rays * (2 * rcfg.n_coarse + rcfg.n_importance)
    model = state.model_fine
    macs = network_macs(model)
    bwd_macs = sum(bwd_passes.backward_macs(model).values())
    bound_ms = 1e3 * 2.0 * (macs + bwd_macs) * points / PEAK_BF16_FLOPS
    say("scannet_step", rays=n_rays, points_each_way=points, classes=c,
        launches=json.dumps(launches), want=2 * TIMED_STEPS,
        kernels_by_name=json.dumps(found), want_by_name=json.dumps(want_named),
        median_ms_per_step=f"{median:.3f}", steps_ms=json.dumps([round(x, 3) for x in step_ms]),
        median_host_enqueue_ms=f"{float(np.median(host_ms)):.3f}",
        rays_per_s=f"{n_rays * 1e3 / median:.0f}", bound_ms_per_step=f"{bound_ms:.3f}",
        macs_per_point=json.dumps({"fwd": macs, "bwd": bwd_macs}),
        profiled_busy_ms=f"{busy_ms:.3f}", profiled_wall_ms=f"{wall_ms:.3f}",
        kernel1_ms=f"{k1:.3f}", kernel2_ms=f"{k2:.3f}",
        last=json.dumps({k: float(f"{float(v):.5g}") for k, v in reports[-1]._asdict().items()}),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    if (launches != {k: 2 * TIMED_STEPS for k in launches} or bad or found != want_named
            or moved != len(before)):
        raise AssertionError(f"the ScanNet step: launches {launches}, by name {found}, "
                             f"not finite {bad[:5]}, {moved} of {len(before)} moved")

    # one step on a 64-pair slice: the card against the plain versions on the host
    from intrinsicnerf_tpu_torch.data.samplers import sample_ray_pairs

    big = sample_ray_pairs(gen.manual_seed(33), pools.rays, pools.rgb, h, w, tcfg.n_rays,
                           depth_pool=pools.depth, sem_pool=pools.semantic,
                           mask_ids=pools.mask_ids)
    idx = torch.cat([torch.arange(SLICE_PAIRS), tcfg.n_rays + torch.arange(SLICE_PAIRS)]).to(dev)
    sl = RayBatch(rays=big.rays[idx], rgb=big.rgb[idx], depth=big.depth[idx],
                  semantic=big.semantic[idx], sem_flag=big.sem_flag, image_idx=big.image_idx)
    draws = draw_train_noise(2 * SLICE_PAIRS, rcfg, gen.manual_seed(34), dev)
    step_vs_host(torch, state, sl, draws, table, w_c, mcfg, rcfg, tcfg, h, w, dev,
                 phase="scannet_step_vs_plain")

    # kernels 1 and 2 at the step's calls: this C, then NYU-40 and NYU-13
    kernels = {}
    for cc in (c, *NYU_WIDTHS):
        model, cc_cfg = semantic_model(torch, cc, dev, 35 + cc)
        kernels[cc] = kernel_checks(torch, np, model, cc_cfg, big.rays, rcfg, card, 36 + cc,
                                    "nyu_kernels_vs_plain")
        del model

    # K steps per call: eager against one CUDA graph replay
    graph = graph_phase(torch, np, step_fn, state, pools, table, w_c, gen, card,
                        phase="scannet_graph")

    del state, step_fn, table
    torch.cuda.empty_cache()
    return {"launches": launches, "median_ms": median, "bound_ms": bound_ms,
            "host_ms": float(np.median(host_ms)), "kernels": kernels, "graph": graph, "c": c}


def scannet_view(torch, np, dev, card, trainer):
    """``scannet_view``: one 324x243 test view (two full chunks and a
    short one) through ``render_views`` of the ScanNet fit's trained
    weights, loaded just before it; kernel 1 twice per chunk and one
    weight image per model; the median of 5 views beside its bound; the
    view against the plain versions on the host on a subset of its rays."""
    from intrinsicnerf_tpu_torch.train.trainer import render_views

    cfg, bundle, mcfg = trainer.cfg, trainer.bundle, trainer.mcfg
    rcfg, chunk, h, w = cfg.render, cfg.chunk, bundle.h, bundle.w
    mc, mf = trainer.state.model_coarse, trainer.state.model_fine
    rays = bundle.rays_test[:1]
    n_view = rays.shape[1]

    def view():
        return next(render_views(mc, mf, mcfg, rcfg, rays, h, w, chunk, device=dev))

    view()
    for mdl in (mc, mf):
        mdl.load_state_dict(mdl.state_dict())
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = view()
    torch.cuda.synchronize()
    times = [1e3 * (time.perf_counter() - t0)]
    launches = run_launches()[0]
    chunks = math.ceil(n_view / chunk)
    for _ in range(4):
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    view_ms = float(np.median(times))
    macs = network_macs(mf)
    view_bound = 1e3 * 2.0 * macs * n_view * (2 * rcfg.n_coarse + rcfg.n_importance) \
        / PEAK_BF16_FLOPS
    shapes_ok = all(out[k].shape[:2] == (h, w) and np.isfinite(out[k]).all()
                    for k in ("rgb", "depth", "albedo", "sem_label"))
    say("scannet_view", view=f"{h}x{w}", rays=n_view, chunk=chunk, chunks=chunks,
        weights=f"the fit at step {trainer.global_step}", launches=json.dumps(launches),
        ms_per_view=json.dumps([round(x, 2) for x in times]),
        median_ms_per_view=f"{view_ms:.2f}", rays_per_s=f"{n_view / view_ms * 1e3:.0f}",
        bound_ms_per_view=f"{view_bound:.2f}", card=json.dumps(card),
        clocks=json.dumps(smi(CLOCKS)))
    if launches != {"fwd": 2 * chunks, "bwd": 0, "image": 2} or not shapes_ok:
        raise AssertionError(f"the ScanNet view: launches {launches}, maps ok {shapes_ok}")
    view_vs_plain(torch, np, mc, mf, mcfg, rcfg, rays[0], out, 36, "scannet_view_vs_plain")
    return {"median_ms": view_ms, "bound_ms": view_bound, "launches": launches["fwd"]}


def resume_state(trainer):
    """What a resumed trainer must restore exactly: the step, the
    parameters, Adam's state, the palette, the anneal and the generator."""
    st = trainer.state
    return {"step": trainer.global_step,
            "params": [p.detach().cpu() for m in (st.model_coarse, st.model_fine)
                       for p in m.parameters()],
            "adam": copy.deepcopy(st.optimizer.state_dict()["state"]),
            "table": [t.cpu() for t in trainer.table[:4]], "anneal": [trainer.w_c, trainer.b_f],
            "generator": trainer.generator.get_state()}


def resume_check(torch, ref, work, cli_module, cli_args, n_iters, k, graphed):
    """A second process of the CLI module at ``cli_args`` resumes, must
    restore ``ref`` (``resume_state``) exactly and trains to ``n_iters``,
    as replays of ``k`` steps when ``graphed``.  Returns its JSON line
    and its seconds."""
    ref_path = os.path.join(work, "state_at_fit_end.pt")
    torch.save(ref, ref_path)
    t0 = time.perf_counter()
    out = run_port(["-c", _RESUME_RUNNER, cli_module, json.dumps(cli_args), ref_path,
                    str(n_iters)])
    resume = json.loads(out.strip().splitlines()[-1])
    if not (all(resume["exact"].values()) and resume["global_step"] == n_iters
            and resume["replays"] == ((n_iters - ref["step"]) // k if graphed else 0)
            and math.isfinite(resume["last_total"])):
        raise AssertionError(f"the resume of {cli_module} failed: {resume}")
    return resume, time.perf_counter() - t0


def scannet_fit_phase(torch, np, dev, card, sd):
    """``scannet_fit``: the scene CLI's trainer (``train_scene.build_trainer``)
    on the scan at steps_per_call SCANNET_K: an evaluation at 0, then
    SCANNET_STEPS steps (log every 50, rebuild and checkpoint every 200,
    an evaluation at 400); launches exact, the loss down, the cluster
    term off until the first rebuild, the PSNR up, mIoU and the depth
    metrics; then a second process resumes exactly and trains SCANNET_MORE
    more steps."""
    from intrinsicnerf_tpu_torch import train_scene

    work = sd["work"]
    cfg_path = scene_yaml(sd["cfg_path"], os.path.join(work, "scannet_fit.yaml"), {
        "experiment.save_dir": os.path.join(work, "fit"), "train.steps_per_call": SCANNET_K})
    cli_args = ["--config_file", cfg_path, "--device", dev.type]
    calls = []

    def hook(done, t_start, t_enqueued, did_work):
        torch.cuda.synchronize()
        calls.append((done, 1e3 * (t_enqueued - t_start), 1e3 * (time.perf_counter() - t_start),
                      did_work, dict(trainer.last_rebuild)))

    zero_launches()
    t0 = time.perf_counter()
    cfg, bundle, trainer = train_scene.build_trainer(train_scene.parse_args(cli_args))
    trainer.step_hook = hook
    with trainer:
        trainer.maybe_resume()
        m0 = trainer.evaluate(0)
        trainer.fit(progress=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eager, captured, total, replays = run_launches(trainer)
    save_dir = cfg.experiment.save_dir
    sc = read_scalars(os.path.join(save_dir, "tfb_logs", "scalars.csv"))
    img = sc["Train/Loss/img_fine"]
    log_steps = sorted(img)
    term = {s: sc["Train/w_c_eff"][s] * sc["Train/Loss/reflect_cluster"][s] for s in log_steps}
    rebuild = SCANNET_CADENCE["step_vis_train"]
    m_end = {k[5:]: v[SCANNET_STEPS] for k, v in sc.items()
             if k.startswith("Test/") and SCANNET_STEPS in v}
    n_test, n_train = bundle.rays_test.shape[0], bundle.rays_vis.shape[0]
    chunks = math.ceil(bundle.h_scaled * bundle.w_scaled / cfg.chunk)
    views = 2 * n_test + n_train * (SCANNET_STEPS // rebuild)  # two evals, the rebuilds
    probes = len(log_steps) if trainer.logger.writer is not None else 0
    eager_steps = SCANNET_STEPS - replays * SCANNET_K + (1 if replays else 0)
    want = {"fwd": 2 * eager_steps + 2 * chunks * views + 2 * probes, "bwd": 2 * eager_steps}
    plain = [x for x in calls if not x[3]]
    median_ms = float(np.median([x[2] for x in plain])) / SCANNET_K
    rebuilds = [x[4] for x in calls if x[0] % rebuild == 0]
    say("scannet_fit", steps=SCANNET_STEPS, steps_per_call=SCANNET_K, seconds=f"{fit_s:.1f}",
        launches=json.dumps(eager), want=json.dumps(want), captured=json.dumps(captured),
        replays=replays, launches_with_replays=json.dumps(total),
        img_fine=json.dumps({s: round(img[s], 5) for s in log_steps}),
        cluster_term=json.dumps({s: round(term[s], 7) for s in log_steps}),
        eval_0=json.dumps({k: round(v, 4) for k, v in m0.items()}),
        eval_end=json.dumps({k: round(v, 4) for k, v in m_end.items()}),
        rebuild_views=json.dumps([r.get("views") for r in rebuilds]))
    say("scannet_fit_time", median_ms_per_plain_step=f"{median_ms:.3f}",
        median_host_enqueue_ms_per_step=(
            f"{float(np.median([x[1] for x in plain])) / SCANNET_K:.3f}"),
        plain_calls=len(plain), steps_per_s=f"{1e3 / median_ms:.2f}",
        rebuilds=json.dumps([{k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in r.items()} for r in rebuilds]),
        work_calls_ms=json.dumps({x[0]: round(x[2], 1) for x in calls if x[3]}),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    before = [s for s in log_steps if s <= rebuild]
    after = [s for s in log_steps if s > rebuild]
    finite = all(math.isfinite(m[k]) for m in (m0, m_end) for k in ("psnr", "miou", "total_acc"))
    graphed = dev.type == "cuda"  # on the host a block of steps is a loop
    ok = (eager["fwd"] == want["fwd"] and eager["bwd"] == want["bwd"]
          and captured == {k: (2 * SCANNET_K if graphed else 0) for k in captured}
          and replays == (SCANNET_STEPS // SCANNET_K if graphed else 0)
          and np.mean([img[s] for s in log_steps[-2:]]) < np.mean([img[s] for s in log_steps[:2]])
          and all(term[s] == 0.0 for s in before) and all(term[s] > 0.0 for s in after)
          and len(rebuilds) == SCANNET_STEPS // rebuild and finite
          and m_end["psnr"] > m0["psnr"])
    if not ok:
        raise AssertionError("the ScanNet run failed a check (see the scannet_fit line)")
    ref = resume_state(trainer)
    view = scannet_view(torch, np, dev, card, trainer)
    del trainer
    torch.cuda.empty_cache()
    resume, resume_s = resume_check(torch, ref, work, "intrinsicnerf_tpu_torch.train_scene",
                                    cli_args, SCANNET_STEPS + SCANNET_MORE, SCANNET_K, graphed)
    say("scannet_resume", seconds=f"{resume_s:.1f}",
        **{k: json.dumps(v) for k, v in resume.items()})
    return {"cfg_path": cfg_path, "launches": total, "eager": eager, "replays": replays,
            "median_ms": median_ms, "m0": m0, "m_end": m_end, "fit_s": fit_s, "view": view}


def scene_all_images_phase(torch, np, dev, card, room_dir):
    """``scene_all_images``: the Replica config with ``render.no_batching:
    false`` on the scene phases' room: GRAPH_K eager steps twice from one
    snapshot and as one replay (``graph_phase``); one batch's pairs drawn
    from several images, each neighbour from its pixel's image (the same
    camera centre); then ALL_IMAGES_STEPS steps of the CLI, over which the
    loss falls."""
    from intrinsicnerf_tpu_torch import train_scene
    from intrinsicnerf_tpu_torch.train.step import create_train_state, make_train_step

    work = os.path.join(ROOT, "logs", "chip_smoke_all_images")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    cfg_path = scene_yaml(CONFIG, os.path.join(work, "all_images.yaml"), {
        "experiment.dataset_dir": room_dir, "experiment.save_dir": os.path.join(work, "run"),
        "render.no_batching": False, "train.N_iters": ALL_IMAGES_STEPS,
        "train.steps_per_call": SCANNET_K, "logging.step_log_tfb": CLI_LOG,
        "logging.step_log_print": CLI_LOG, "logging.step_save_ckpt": 10 ** 9,
        "logging.step_vis_train": 10 ** 9, "logging.step_val": 10 ** 9})
    split = ["--total_frames", str(SCENE_FRAMES), "--split_step", str(SCENE_SPLIT)]
    args = train_scene.parse_args(["--config_file", cfg_path, "--device", dev.type, *split])
    from intrinsicnerf_tpu_torch.config import from_yaml

    cfg = from_yaml(cfg_path)
    bundle = train_scene.prepare_bundle(cfg, train_scene.build_dataset(cfg, args), dev)
    mcfg = dataclasses.replace(cfg.mlp, num_semantic_classes=bundle.num_valid_classes)
    sample_fn = train_scene.all_images_sample_fn(cfg, bundle)
    state = create_train_state(mcfg, cfg.train, device=dev,
                               generator=torch.Generator().manual_seed(40))
    step_fn = make_train_step(mcfg, cfg.render, cfg.train, bundle.h, bundle.w,
                              sample_fn=sample_fn)
    gen = torch.Generator(device=dev).manual_seed(41)
    table = one_class_table(np, dev, 42, n_classes=bundle.num_valid_classes)
    step_fn(state, bundle.pools, table, 0.1, gen)  # Adam's state made
    graph = graph_phase(torch, np, step_fn, state, bundle.pools, table, 0.1, gen, card,
                        phase="all_images_graph")
    n = cfg.train.n_rays
    batch = sample_fn(gen.manual_seed(43), bundle.pools, state.step_t)
    origins = batch.rays[:, 0:3]
    n_images = len(torch.unique(origins[:n], dim=0))
    pairs_same_image = torch.equal(origins[:n], origins[n:])
    del state, step_fn, table
    torch.cuda.empty_cache()

    zero_launches()
    t0 = time.perf_counter()
    _, _, trainer = train_scene.build_trainer(args)
    with trainer:
        trainer.fit(progress=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eager, _, total, replays = run_launches(trainer)
    sc = read_scalars(os.path.join(cfg.experiment.save_dir, "tfb_logs", "scalars.csv"))
    img = sc["Train/Loss/img_fine"]
    log_steps = sorted(img)
    say("scene_all_images", images_in_a_batch=n_images, train_views=bundle.pools.rgb.shape[0],
        neighbours_share_their_image=pairs_same_image, graph_bitwise=graph["eager_bitwise"],
        cli_steps=ALL_IMAGES_STEPS, seconds=f"{fit_s:.1f}", launches=json.dumps(eager),
        replays=replays, launches_with_replays=json.dumps(total),
        img_fine=json.dumps({s: round(img[s], 5) for s in log_steps}))
    graphed = dev.type == "cuda"  # a capture warms up with one eager step
    loss_fell = np.mean([img[s] for s in log_steps[-2:]]) < np.mean([img[s] for s in log_steps[:2]])
    if not (n_images > 1 and pairs_same_image and loss_fell
            and total["bwd"] == 2 * ALL_IMAGES_STEPS + (2 if graphed else 0)
            and replays == (ALL_IMAGES_STEPS // SCANNET_K if graphed else 0)):
        raise AssertionError(f"the all-images run: {n_images} images a batch, pairs in one image "
                             f"{pairs_same_image}, launches {total}, losses {img}")
    return {"launches": total, "graph": graph, "images_in_a_batch": n_images}


def replica_nyu_phase(torch, np, dev, card, room_dir):
    """``replica_nyu``: the scene phases' room in the Replica-NYU layout
    (``write_replica_nyu_from_replica``: NYU-13 ground truth, "CNN" labels
    with 10% of the pixels flipped), NYU_STEPS steps of the CLI on the CNN
    labels (``nyu_mode: nyu13``), then an evaluation against the ground
    truth; the written label images carry the NYU-13 palette."""
    import shutil

    from intrinsicnerf_tpu_torch import train_scene
    from intrinsicnerf_tpu_torch.tools.synthetic_replica import write_replica_nyu_from_replica
    from intrinsicnerf_tpu_torch.utils.image import imread, nyu13_colour_code

    work = os.path.join(ROOT, "logs", "chip_smoke_replica_nyu")
    shutil.rmtree(work, ignore_errors=True)
    nyu_dir = os.path.join(work, "data")
    write_replica_nyu_from_replica(room_dir, nyu_dir)
    cfg_path = scene_yaml(CONFIG, os.path.join(work, "replica_nyu.yaml"), {
        "experiment.dataset_type": "replica_nyu_cnn", "experiment.nyu_mode": "nyu13",
        "experiment.dataset_dir": nyu_dir, "experiment.save_dir": os.path.join(work, "run"),
        "train.N_iters": NYU_STEPS, "train.steps_per_call": SCANNET_K,
        "logging.step_log_tfb": CLI_LOG, "logging.step_log_print": CLI_LOG,
        "logging.step_save_ckpt": 10 ** 9, "logging.step_vis_train": 10 ** 9,
        "logging.step_val": NYU_STEPS})
    zero_launches()
    t0 = time.perf_counter()
    cfg, bundle, trainer = train_scene.build_trainer(train_scene.parse_args(
        ["--config_file", cfg_path, "--device", dev.type, "--total_frames", str(SCENE_FRAMES),
         "--split_step", str(SCENE_SPLIT)]))
    with trainer:
        trainer.fit(progress=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eager, _, total, replays = run_launches(trainer)
    sc = read_scalars(os.path.join(cfg.experiment.save_dir, "tfb_logs", "scalars.csv"))
    m_end = {k[5:]: round(v[NYU_STEPS], 4) for k, v in sc.items()
             if k.startswith("Test/") and NYU_STEPS in v}
    palette = {tuple(c) for c in (np.asarray(nyu13_colour_code) * 255).astype(np.uint8)}
    test_dir = os.path.join(cfg.experiment.save_dir, "test_render", f"step_{NYU_STEPS:06d}")
    colours = set()
    for i in range(bundle.rays_test.shape[0]):
        vis = imread(os.path.join(test_dir, f"vis_label_{i:03d}.png"))
        colours |= {tuple(c) for c in np.unique(vis.reshape(-1, 3), axis=0)}
    say("replica_nyu", steps=NYU_STEPS, seconds=f"{fit_s:.1f}", classes=bundle.num_valid_classes,
        names=json.dumps(bundle.class_names), launches=json.dumps(eager), replays=replays,
        launches_with_replays=json.dumps(total), eval_vs_gt=json.dumps(m_end),
        label_colours=len(colours), colours_in_nyu13_palette=colours <= palette)
    if not (colours and colours <= palette and bundle.class_names[0] == "void"
            and len(bundle.class_names) == 14
            and total["bwd"] == 2 * NYU_STEPS + (2 if dev.type == "cuda" else 0)
            and all(math.isfinite(m_end[k]) for k in ("psnr", "miou", "total_acc"))):
        raise AssertionError(f"the Replica-NYU run: colours {sorted(colours - palette)[:5]} off "
                             f"the palette, launches {total}, eval {m_end}")
    return {"launches": total, "eval": m_end}


def degradations_phase(torch, np, dev, card, room_dir):
    """``degradations``: each of the five label-degradation flags through
    the scene CLI's trainer for DEGRADE_STEPS steps on the scene phases'
    room; its pools on the card hold the degraded labels (pixels changed
    or voided against the clean labels, frames without supervision)."""
    import shutil

    from intrinsicnerf_tpu_torch import train_scene

    work = os.path.join(ROOT, "logs", "chip_smoke_degradations")
    shutil.rmtree(work, ignore_errors=True)
    base = ["--device", dev.type, "--total_frames", str(SCENE_FRAMES), "--split_step",
            str(SCENE_SPLIT)]
    clean = None
    out = {}
    for name, flags in DEGRADATIONS.items():
        cfg_path = scene_yaml(CONFIG, os.path.join(work, f"{name}.yaml"), {
            "experiment.dataset_dir": room_dir, "experiment.save_dir": os.path.join(work, name),
            "train.N_iters": DEGRADE_STEPS, "logging.step_log_tfb": DEGRADE_STEPS,
            "logging.step_log_print": DEGRADE_STEPS, "logging.step_save_ckpt": 10 ** 9,
            "logging.step_vis_train": 10 ** 9, "logging.step_val": 10 ** 9})
        args = train_scene.parse_args(["--config_file", cfg_path, *base, *flags])
        if clean is None:
            from intrinsicnerf_tpu_torch.config import from_yaml

            plain_args = train_scene.parse_args(["--config_file", cfg_path, *base])
            data = train_scene.build_dataset(from_yaml(cfg_path), plain_args)
            clean = torch.from_numpy(data.train_samples["semantic_remap"].reshape(
                len(data.train_ids), -1)).to(dev)
        zero_launches()
        t0 = time.perf_counter()
        cfg, bundle, trainer = train_scene.build_trainer(args)
        labels, mask_ids = bundle.pools.semantic, bundle.pools.mask_ids
        counts = {"changed": int((labels != clean).sum()),
                  "voided": int(((labels == 0) & (clean != 0)).sum()),
                  "unsupervised_frames": int((mask_ids == 0).sum()), "pixels": labels.numel()}
        with trainer:
            trainer.fit(progress=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        eager = run_launches()[0]
        sc = read_scalars(os.path.join(cfg.experiment.save_dir, "tfb_logs", "scalars.csv"))
        last = {k[11:]: round(v[DEGRADE_STEPS], 5) for k, v in sc.items()
                if k.startswith("Train/Loss/") and DEGRADE_STEPS in v}
        say("degradations", flag=name, args=json.dumps(flags), seconds=f"{secs:.1f}",
            counts=json.dumps(counts), launches=json.dumps(eager), last=json.dumps(last))
        degraded = (counts["unsupervised_frames"] > 0 if name == "sparse_views"
                    else counts["changed"] > 0)
        if name == "label_propagation":
            degraded = counts["voided"] > 0
        if not (degraded and eager["bwd"] == 2 * DEGRADE_STEPS and last
                and all(math.isfinite(v) for v in last.values())):
            raise AssertionError(f"--{name}: labels {counts}, launches {eager}, losses {last}")
        out[name] = {"counts": counts, "launches": eager}
        del trainer, bundle
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- objects


def object_txt(src, work, data_dir, expname, n_iters, **extra):
    """A copy of the object config ``src`` in ``work`` with only the data
    paths, the run's name and length, the cadences and ``extra`` changed
    (``testskip`` 1 keeps the synthetic object's 5 test views)."""
    changed = {"datadir": data_dir, "basedir": work, "expname": expname, "N_iters": n_iters,
               "testskip": 1, **OBJ_CADENCE, **extra}
    lines = [ln for ln in open(src).read().splitlines()
             if ln.split("#")[0].split("=")[0].strip() not in changed]
    path = os.path.join(work, f"{expname}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines + [f"{k} = {v}" for k, v in changed.items()]) + "\n")
    return path


def object_data_phase(torch, np, dev, card):
    """``object_data``: the synthetic object at 800x800 (24 train, 1 val,
    5 test views), loaded by the CLI's loader at a copy of the lego config,
    and its bundle on the card."""
    import shutil

    from intrinsicnerf_tpu_torch.config import from_object_txt
    from intrinsicnerf_tpu_torch.tools.synthetic_blender import write_synthetic_blender
    from intrinsicnerf_tpu_torch.train.prepare import prepare_blender_bundle
    from intrinsicnerf_tpu_torch.train_object import load_object_data

    work = os.path.join(ROOT, "logs", "chip_smoke_object")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_dir = os.path.join(work, "data")
    t0 = time.perf_counter()
    report = write_synthetic_blender(data_dir, OBJ_RES, OBJ_RES, *OBJ_VIEWS)
    data_s = time.perf_counter() - t0
    cfg_path = object_txt(OBJ_CONFIG, work, data_dir, "lego", OBJ_STEPS, steps_per_call=OBJ_K)
    cfg = from_object_txt(cfg_path)
    m, r, t = cfg.mlp, cfg.render, cfg.train
    got = ((m.depth, m.width, m.use_viewdirs, m.use_fused_kernel, m.enable_semantic),
           (r.n_coarse, r.n_importance, r.white_bkgd, r.perturb), (t.n_rays, t.mask_mode),
           (cfg.half_res, cfg.precrop_iters, cfg.precrop_frac))
    if got != OBJ_WANT:
        raise AssertionError(f"{OBJ_CONFIG} no longer sets the lego configuration: {got}")
    t0 = time.perf_counter()
    data = load_object_data(cfg)
    bundle, pools = prepare_blender_bundle(cfg, data, device=dev)
    load_s = time.perf_counter() - t0
    counts = [len(s) for s in data.i_split]
    say("object_data", tool=json.dumps(report), seconds=f"{data_s:.1f}",
        load_seconds=f"{load_s:.1f}", h=data.h, w=data.w, focal=f"{data.focal:.4f}",
        train_val_test=json.dumps(counts), render_path=len(data.render_poses),
        config=os.path.relpath(OBJ_CONFIG, ROOT))
    if (data.h, data.w) != (OBJ_RES // 2, OBJ_RES // 2) or counts != list(OBJ_VIEWS):
        raise AssertionError(f"the object loaded at {data.h}x{data.w} with {counts} views")
    return {"work": work, "data_dir": data_dir, "cfg_path": cfg_path, "cfg": cfg,
            "bundle": bundle, "pools": pools, "focal": data.focal}


def object_mlp_config(cfg):
    """The MLP an object trains: the semantic head off, as ``Trainer`` sets it."""
    return dataclasses.replace(cfg.mlp, num_semantic_classes=0, enable_semantic=False)


def one_class_table(np, dev, seed, n_classes=1):
    """A seeded palette of ``n_classes`` classes (an object's table: one),
    8 centres and 2,048 anchors per class."""
    from intrinsicnerf_tpu_torch.cluster.assign import map_drgb, table_from_numpy

    rng = np.random.default_rng(seed)
    per_class = []
    for _ in range(n_classes):
        centers = rng.uniform(0.05, 1.0, size=(8, 3)).astype(np.float32)
        links = rng.integers(0, 8, size=2048)
        anchors = map_drgb(centers[links]) + rng.normal(size=(2048, 3)).astype(np.float32) * 0.02
        per_class.append((anchors, links, centers))
    return table_from_numpy(per_class, 2048, device=dev)


def object_step_phase(torch, np, dev, card, od):
    """``object_step``: the lego step (1,024 pairs from the pose sampler,
    64 + 128 samples, the semantic head off) 3 + 20 times eagerly, its
    kernels found by name in a profiled step, one step on a 64-pair slice
    against the plain versions on the host, then kernels 1 and 2 at the
    step's coarse and fine calls against their plain versions."""
    from intrinsicnerf_tpu_torch.data.samplers import RayBatch
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.render.pipeline import draw_train_noise
    from intrinsicnerf_tpu_torch.tools import bwd_passes
    from intrinsicnerf_tpu_torch.train.step import create_train_state, make_train_step
    from intrinsicnerf_tpu_torch.train.trainer import make_object_sample_fn

    cfg, bundle, pools = od["cfg"], od["bundle"], od["pools"]
    mcfg, rcfg, tcfg = object_mlp_config(cfg), cfg.render, cfg.train
    h, w = bundle.h, bundle.w
    state = create_train_state(mcfg, tcfg, device=dev, generator=torch.Generator().manual_seed(20))
    sample_fn = make_object_sample_fn(cfg, bundle)
    step_fn = make_train_step(mcfg, rcfg, tcfg, h, w, sample_fn=sample_fn)
    gen = torch.Generator(device=dev).manual_seed(21)
    table = one_class_table(np, dev, 22)
    w_c = 0.1
    for _ in range(WARM_STEPS):
        step_fn(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in state.model_fine.parameters()]
    counters = (fm.fused_mlp_forward, fm.fused_mlp_backward, fm.fwd_weight_image)
    for c in counters:
        c.launches = 0
    step_ms, host_ms, reports = [], [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        reports.append(step_fn(state, pools, table, w_c, gen))
        host_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(zip(("fwd", "bwd", "fwd_image"), (c.launches for c in counters)))
    bad = [(i, k) for i, r in enumerate(reports) for k, v in r._asdict().items()
           if not math.isfinite(float(v))]
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(state.model_fine.parameters(), before))
    # the kernels of one profiled step, by name
    named = {}
    wall_ms, busy_ms, by_name = profile_window(
        lambda: step_fn(state, pools, table, w_c, gen), torch, counts=named)
    found = {k: sum(v for name, v in named.items() if k in name) for k in REPLAY_KERNELS}
    want_named = {k: 2 * v for k, v in REPLAY_KERNELS.items()}
    k1 = sum(v for k, v in by_name.items() if "fused_mlp_fwd_kernel" in k)
    k2 = sum(v for k, v in by_name.items() if any(s in k for s in bwd_passes.PASSES.values()))
    median = float(np.median(step_ms))
    n_rays = 2 * tcfg.n_rays
    points = n_rays * (2 * rcfg.n_coarse + rcfg.n_importance)  # coarse + fine, each way
    model = state.model_fine
    macs = network_macs(model)
    bwd_macs = sum(bwd_passes.backward_macs(model).values())
    bound_ms = 1e3 * 2.0 * (macs + bwd_macs) * points / PEAK_BF16_FLOPS
    say("object_step", rays=n_rays, points_each_way=points, launches=json.dumps(launches),
        want=2 * TIMED_STEPS, kernels_by_name=json.dumps(found), want_by_name=json.dumps(want_named),
        median_ms_per_step=f"{median:.3f}", steps_ms=json.dumps([round(x, 3) for x in step_ms]),
        median_host_enqueue_ms=f"{float(np.median(host_ms)):.3f}",
        rays_per_s=f"{n_rays * 1e3 / median:.0f}", bound_ms_per_step=f"{bound_ms:.3f}",
        macs_per_point=json.dumps({"fwd": macs, "bwd": bwd_macs}),
        profiled_busy_ms=f"{busy_ms:.3f}", profiled_wall_ms=f"{wall_ms:.3f}",
        kernel1_ms=f"{k1:.3f}", kernel2_ms=f"{k2:.3f}",
        last=json.dumps({k: float(f"{float(v):.5g}") for k, v in reports[-1]._asdict().items()}),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    if (launches != {k: 2 * TIMED_STEPS for k in launches} or bad or found != want_named
            or moved != len(before)):
        raise AssertionError(f"the object step: launches {launches}, by name {found}, "
                             f"not finite {bad[:5]}, {moved} of {len(before)} moved")

    # one step on a 64-pair slice: the card against the plain versions on the host
    big = sample_fn(gen.manual_seed(24), pools, state.step_t)
    idx = torch.cat([torch.arange(SLICE_PAIRS), tcfg.n_rays + torch.arange(SLICE_PAIRS)]).to(dev)
    sl = RayBatch(rays=big.rays[idx], rgb=big.rgb[idx], depth=None, semantic=big.semantic[idx],
                  sem_flag=big.sem_flag, image_idx=big.image_idx)
    draws = draw_train_noise(2 * SLICE_PAIRS, rcfg, gen.manual_seed(25), dev)
    step_vs_host(torch, state, sl, draws, table, w_c, mcfg, rcfg, tcfg, h, w, dev,
                 phase="object_step_vs_plain")
    kernels = kernel_checks(torch, np, model, mcfg, big.rays, rcfg, card, 23,
                            "object_kernels_vs_plain")
    return {"state": state, "step_fn": step_fn, "sample_fn": sample_fn, "gen": gen,
            "table": table, "mcfg": mcfg, "launches": launches, "median_ms": median,
            "host_ms": float(np.median(host_ms)), "bound_ms": bound_ms, "kernels": kernels}


def batch_pixels(torch, batch, pools, h, w, focal, n):
    """(rows, columns) of a batch's first ``n`` rays (its pixels, not their
    neighbours), recovered from their directions in the camera's frame."""
    rot = pools.poses[batch.image_idx.reshape(1)][0, :3, :3]
    d = batch.rays[:n, 3:6] @ rot
    cols = torch.round(d[:, 0] / -d[:, 2] * focal + w * 0.5).long()
    rows = torch.round(h * 0.5 - d[:, 1] / -d[:, 2] * focal).long()
    return rows, cols


def object_graph_phase(torch, np, dev, card, od, st):
    """``object_graph``: starting OBJ_GRAPH_K / 2 steps before the precrop
    warm-up ends, GRAPH_K eager steps twice from one snapshot (bitwise or
    not) and as one graph replay (``graph_phase``); then the pixels each
    step drew, recorded on the device by step count inside the steps: the
    replay's equal the eager steps', the first half inside the centre
    crop, the second half not all inside it."""
    from intrinsicnerf_tpu_torch.train.step import (
        make_multi_step, make_train_step, restore_state, snapshot_state)

    cfg, bundle, pools = od["cfg"], od["bundle"], od["pools"]
    state, gen, table = st["state"], st["gen"], st["table"]
    k = GRAPH_K
    start = cfg.precrop_iters - k // 2
    state.step = start
    state.step_t.fill_(start)
    graph = graph_phase(torch, np, st["step_fn"], state, pools, table, 0.1, gen, card,
                        phase="object_graph")
    graph["packed"] = packed_phase(torch, np, dev, card, st["mcfg"], cfg.train, st["step_fn"],
                                   pools, table, 0.1, 20, "object_packed", start=start)

    n = cfg.train.n_rays
    rec = torch.full((2, k, n), -1, dtype=torch.long, device=dev)

    def recording(generator, pools_, step):
        batch = st["sample_fn"](generator, pools_, step)
        rows, cols = batch_pixels(torch, batch, pools_, bundle.h, bundle.w,
                                  od["focal"], n)
        i = (step - start).clamp(0, k - 1).reshape(1)
        rec[0].index_copy_(0, i, rows[None])
        rec[1].index_copy_(0, i, cols[None])
        return batch

    rec_step = make_train_step(st["mcfg"], cfg.render, cfg.train, bundle.h, bundle.w,
                               sample_fn=recording)
    w_c_t = torch.tensor(0.1, device=dev)
    snap = snapshot_state(state, gen)
    for _ in range(k):
        rec_step(state, pools, table, w_c_t, gen)
    torch.cuda.synchronize()
    eager_px = rec.clone()
    restore_state(state, snap, gen)
    rec.fill_(-1)
    multi = make_multi_step(rec_step, k)
    multi(state, pools, table, w_c_t, gen)
    torch.cuda.synchronize()
    graph_px = rec.clone()
    restore_state(state, snap, gen)
    del multi
    h, w = bundle.h, bundle.w
    dh = max(int(h // 2 * cfg.precrop_frac), 1)
    dw = max(int(w // 2 * cfg.precrop_frac), 1)
    inside = ((graph_px[0] >= h // 2 - dh) & (graph_px[0] < h // 2 + dh)
              & (graph_px[1] >= w // 2 - dw) & (graph_px[1] < w // 2 + dw)).all(dim=1).tolist()
    want_inside = [s < cfg.precrop_iters for s in range(start, start + k)]
    same = torch.equal(eager_px, graph_px)
    say("object_graph_precrop", start=start, precrop_iters=cfg.precrop_iters,
        steps_all_pixels_in_crop=json.dumps(inside), want=json.dumps(want_inside),
        replay_pixels_equal_eager=same, crop_rows=json.dumps([h // 2 - dh, h // 2 + dh]))
    if not same or inside != want_inside or int((graph_px < 0).sum()):
        raise AssertionError(f"the graphed object steps' crop: {inside} (want {want_inside}), "
                             f"pixels equal to the eager steps' {same}")
    torch.cuda.empty_cache()
    return graph


def object_view_phase(torch, np, dev, card, od, st):
    """``object_view``: one 400x400 test view through ``render_views`` of
    weights loaded just before it (five chunks of 32,768 rays, the last
    one short), against the plain version on a seeded subset of its rays;
    the median of 5 views, kernel 1's share of a profiled view, and the
    view's bound at the object network's multiply-adds."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.train.trainer import render_views

    cfg, bundle = od["cfg"], od["bundle"]
    mcfg, rcfg, chunk = st["mcfg"], cfg.render, cfg.chunk
    mc, mf = st["state"].model_coarse, st["state"].model_fine
    h, w = bundle.h, bundle.w
    rays = bundle.rays_test[:1]
    n_rays = rays.shape[1]

    def view():
        return next(render_views(mc, mf, mcfg, rcfg, rays, h, w, chunk, device=dev))

    view()  # warm-up
    for m in (mc, mf):
        m.load_state_dict(m.state_dict())
    torch.cuda.synchronize()
    fm.fused_mlp_forward.launches = fm.fused_mlp_backward.launches = 0
    fm.fwd_weight_image.launches = 0
    t0 = time.perf_counter()
    out = view()
    torch.cuda.synchronize()
    times = [1e3 * (time.perf_counter() - t0)]
    launches = (fm.fused_mlp_forward.launches, fm.fused_mlp_backward.launches,
                fm.fwd_weight_image.launches)
    chunks = math.ceil(n_rays / chunk)
    shapes = {"rgb": (h, w, 3), "disp": (h, w), "depth": (h, w), "acc": (h, w),
              "albedo": (h, w, 3), "shading": (h, w), "residual": (h, w, 3)}
    bad = [k for k, s in shapes.items() if out[k].shape != s or not np.isfinite(out[k]).all()]
    if launches != (2 * chunks, 0, 2) or bad or "sem_label" in out:
        raise AssertionError(f"the object view launched {launches} (want {(2 * chunks, 0, 2)}); "
                             f"bad maps {bad}; keys {sorted(out)}")
    for _ in range(4):
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    median = float(np.median(times))
    macs = st["kernels"]["macs"]
    points = n_rays * (2 * rcfg.n_coarse + rcfg.n_importance)
    bound_ms = 1e3 * 2.0 * macs * points / PEAK_BF16_FLOPS
    wall_ms, busy_ms, by_name = profile_window(view, torch)
    k1 = sum(v for k, v in by_name.items() if "fused_mlp_fwd_kernel" in k)
    say("object_view", view=f"{h}x{w}", rays=n_rays, chunk=chunk, chunks=chunks,
        launches=json.dumps(launches), ms_per_view=json.dumps([round(x, 2) for x in times]),
        median_ms_per_view=f"{median:.2f}", rays_per_s=f"{n_rays / median * 1e3:.0f}",
        bound_ms_per_view=f"{bound_ms:.2f}", macs_per_point=macs,
        profiled_wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", kernel1_ms=f"{k1:.2f}",
        kernel1_share=f"{k1 / busy_ms:.3f}", top_kernels_ms=json.dumps(top(by_name)),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    if k1 <= 0.0:
        raise AssertionError(f"kernel 1 not found among the profiled view's kernels {sorted(by_name)}")
    view_vs_plain(torch, np, mc, mf, mcfg, rcfg, rays[0], out, 26, "object_view_vs_plain")
    return {"median_ms": median, "bound_ms": bound_ms, "launches": launches[0],
            "kernel1_share": k1 / busy_ms, "busy_share": busy_ms / wall_ms}


# the second process of object_fit and scannet_fit: the CLI's trainer (of
# the CLI module named) at the same arguments, resumed, held to the state
# the first process left, then trained on
_RESUME_RUNNER = """
import importlib, json, sys, torch
cli = importlib.import_module(sys.argv[1])
cli_args, ref_path, n_iters = json.loads(sys.argv[2]), sys.argv[3], int(sys.argv[4])
_, _, trainer = cli.build_trainer(cli.parse_args(cli_args))
ref = torch.load(ref_path, weights_only=False)
def same(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b
with trainer as t:
    step = t.maybe_resume()
    st = t.state
    exact = {
        "step": step == ref["step"] == int(st.step_t),
        "params": same(ref["params"], [p.detach() for m in (st.model_coarse, st.model_fine)
                                       for p in m.parameters()]),
        "adam": same(ref["adam"], st.optimizer.state_dict()["state"]),
        "palette": same(ref["table"], list(t.table[:4])),
        "anneal": [t.w_c, t.b_f] == ref["anneal"],
        "generator": same(ref["generator"], t.generator.get_state()),
    }
    report = t.fit(n_iters=n_iters, progress=False)
    replays = t.multi_step.replays if t.multi_step is not None else 0
if torch.distributed.is_initialized():  # the data-parallel CLI's one-rank group
    torch.distributed.destroy_process_group()
print(json.dumps({"exact": exact, "global_step": t.global_step, "replays": replays,
                  "last_total": float(report.total)}))
"""


def run_port(args, timeout=900):
    """Run a command of the port in a subprocess from the repo root; its
    stdout, raising with its stderr's tail when it fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{args[:3]} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc.stdout


def object_fit_phase(torch, np, dev, card, od):
    """``object_fit``: the CLI's trainer (``train_object.build_trainer``)
    at the lego config with ``steps_per_call`` OBJ_K for OBJ_STEPS steps
    (log every 100, checkpoint, rebuild and evaluation every 300; the
    precrop warm-up ends at 500); its launches (eager + replays x the
    launches recorded into the graph, 2 x OBJ_K of each kernel), falling loss, cluster term off until the first rebuild, the
    rebuild of the 5 test views, rising PSNR and every ``_save_view``
    file; then a second process that resumes exactly and trains OBJ_MORE
    steps, ``--render_only --render_test`` in a third, and steps of
    ``intrinsic_lego.txt``'s loader on the same directory."""
    from intrinsicnerf_tpu_torch import train_object
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    cfg, work = od["cfg"], od["work"]
    counters = {"fwd": fm.fused_mlp_forward, "bwd": fm.fused_mlp_backward,
                "image": fm.fwd_weight_image}
    calls = []

    def hook(done, t_start, t_enqueued, did_work):
        torch.cuda.synchronize()
        calls.append((done, 1e3 * (t_enqueued - t_start), 1e3 * (time.perf_counter() - t_start),
                      did_work, dict(trainer.last_rebuild)))

    for c in counters.values():
        c.launches = c.captured = 0
    t0 = time.perf_counter()
    args = train_object.parse_args(["--config", od["cfg_path"], "--device", dev.type])
    _, _, trainer = train_object.build_trainer(args)
    trainer.step_hook = hook
    with trainer:
        trainer.maybe_resume()
        trainer.fit(progress=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eager = {k: c.launches for k, c in counters.items()}
    captured = {k: c.captured for k, c in counters.items()}
    replays = trainer.multi_step.replays if trainer.multi_step is not None else 0
    total = {k: eager[k] + replays * captured[k] for k in counters}
    save_dir = cfg.experiment.save_dir
    sc = read_scalars(os.path.join(save_dir, "tfb_logs", "scalars.csv"))
    log_steps = sorted(sc["Train/Loss/img_fine"])
    img = sc["Train/Loss/img_fine"]
    cluster, w_c_eff = sc["Train/Loss/reflect_cluster"], sc["Train/w_c_eff"]
    rebuild = OBJ_CADENCE["i_testset"]
    term = {s: w_c_eff[s] * cluster[s] for s in log_steps}
    psnr = sc.get("Test/psnr", {})
    n_test = od["bundle"].rays_test.shape[0]
    missing = []
    for sub in ("test_render", "train_render"):
        for s in range(rebuild, OBJ_STEPS + 1, rebuild):
            d = os.path.join(save_dir, sub, f"step_{s:06d}")
            missing += [os.path.join(sub, f"step_{s:06d}", f"{n}_{i:03d}.png")
                        for n in OBJ_SAVE_VIEW for i in range(n_test)
                        if not os.path.exists(os.path.join(d, f"{n}_{i:03d}.png"))]
    videos = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        save_dir, "test_render", f"step_{OBJ_STEPS:06d}", "*.mp4")))
    rebuilds = [c[4] for c in calls if c[0] % rebuild == 0]
    chunks = math.ceil(od["bundle"].h * od["bundle"].w / cfg.chunk)
    views = 2 * n_test * (OBJ_STEPS // rebuild)  # rebuild and evaluation renders
    probes = len(log_steps) if trainer.logger.writer is not None else 0
    eager_steps = OBJ_STEPS - replays * OBJ_K + (1 if replays else 0)
    want = {"fwd": 2 * eager_steps + 2 * chunks * views + 2 * probes, "bwd": 2 * eager_steps}
    plain = [c for c in calls if not c[3]]
    median_ms = float(np.median([c[2] for c in plain])) / OBJ_K
    say("object_fit", steps=OBJ_STEPS, steps_per_call=OBJ_K, seconds=f"{fit_s:.1f}",
        launches=json.dumps(eager), want=json.dumps(want), captured=json.dumps(captured),
        replays=replays, launches_with_replays=json.dumps(total), log_steps=json.dumps(log_steps),
        img_fine=json.dumps({s: round(img[s], 5) for s in log_steps}),
        cluster_term=json.dumps({s: round(term[s], 7) for s in log_steps}),
        eval_psnr=json.dumps(psnr), rebuild_views=json.dumps([r.get("views") for r in rebuilds]),
        missing_files=json.dumps(missing[:10]), videos=json.dumps(videos))
    say("object_fit_time", median_ms_per_plain_step=f"{median_ms:.3f}",
        median_host_enqueue_ms_per_step=f"{float(np.median([c[1] for c in plain])) / OBJ_K:.3f}",
        plain_calls=len(plain), steps_per_s=f"{1e3 / median_ms:.2f}",
        rebuilds=json.dumps([{k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in r.items()} for r in rebuilds]),
        work_calls_ms=json.dumps({c[0]: round(c[2], 1) for c in calls if c[3]}),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    before = [s for s in log_steps if s <= rebuild]
    after = [s for s in log_steps if s > rebuild]
    graphed = dev.type == "cuda"  # on the host a block of steps is a loop
    ok = (eager["bwd"] == want["bwd"] and eager["fwd"] == want["fwd"]
          and captured == {k: (2 * OBJ_K if graphed else 0) for k in counters}
          and replays == (OBJ_STEPS // OBJ_K if graphed else 0)
          and np.mean([img[s] for s in log_steps[-2:]]) < np.mean([img[s] for s in log_steps[:2]])
          and all(term[s] == 0.0 for s in before) and all(term[s] > 0.0 for s in after)
          and [r.get("views") for r in rebuilds] == [n_test] * (OBJ_STEPS // rebuild)
          and psnr.get(OBJ_STEPS, -1) > psnr.get(rebuild, 1e9) and not missing)
    if not ok:
        raise AssertionError("the object run failed a check (see the object_fit line)")

    # ---- a second process resumes exactly and trains on ----
    ref = resume_state(trainer)
    del trainer
    torch.cuda.empty_cache()
    resume, resume_s = resume_check(
        torch, ref, work, "intrinsicnerf_tpu_torch.train_object",
        ["--config", od["cfg_path"], "--device", dev.type], OBJ_STEPS + OBJ_MORE, OBJ_K, graphed)
    say("object_resume", seconds=f"{resume_s:.1f}", **{k: json.dumps(v) for k, v in resume.items()})

    # ---- --render_only --render_test in a third ----
    t0 = time.perf_counter()
    out = run_port(["-m", "intrinsicnerf_tpu_torch.train_object", "--config", od["cfg_path"],
                    "--render_only", "--render_test", "--no_progress", "--device", dev.type])
    render_s = time.perf_counter() - t0
    rdir = os.path.join(save_dir, f"renderonly_test_{OBJ_STEPS:06d}")
    missing = [f"{n}_{i:03d}.png" for n in OBJ_SAVE_VIEW for i in range(n_test)
               if not os.path.exists(os.path.join(rdir, f"{n}_{i:03d}.png"))]
    say("object_render_only", seconds=f"{render_s:.1f}", dir=os.path.relpath(rdir, ROOT),
        views=n_test, missing_files=json.dumps(missing), said=json.dumps(out.strip()[-80:]))
    if missing or f"resumed from step {OBJ_STEPS}" not in out:
        raise AssertionError(f"--render_only --render_test: missing {missing}; said {out[-400:]}")

    # ---- intrinsic_lego.txt's loader (blender_intrinsic) on the same directory ----
    icfg = object_txt(OBJ_INTRINSIC_CONFIG, work, od["data_dir"], "intrinsic_lego",
                      OBJ_INTRINSIC_STEPS, i_print=OBJ_INTRINSIC_STEPS, i_weights=10 ** 9,
                      i_testset=10 ** 9)
    for c in counters.values():
        c.launches = c.captured = 0
    t0 = time.perf_counter()
    train_object.main(["--config", icfg, "--no_progress", "--device", dev.type])
    torch.cuda.synchronize()
    intr_s = time.perf_counter() - t0
    intr = {k: c.launches for k, c in counters.items()}
    isc = read_scalars(os.path.join(work, "intrinsic_lego", "tfb_logs", "scalars.csv"))
    last = {k[11:]: v[OBJ_INTRINSIC_STEPS] for k, v in isc.items()
            if k.startswith("Train/Loss/") and OBJ_INTRINSIC_STEPS in v}
    say("object_intrinsic", steps=OBJ_INTRINSIC_STEPS, seconds=f"{intr_s:.1f}",
        launches=json.dumps(intr), last=json.dumps({k: round(v, 5) for k, v in last.items()}))
    if (intr["bwd"] != 2 * OBJ_INTRINSIC_STEPS or not last
            or not all(math.isfinite(v) for v in last.values())):
        raise AssertionError(f"the blender_intrinsic run: launches {intr}, losses {last}")
    return {"launches": total, "eager": eager, "replays": replays, "median_ms": median_ms,
            "rebuilds": rebuilds, "psnr": psnr, "fit_s": fit_s}


def object_llff_phase(torch, np, dev, card, od):
    """``object_llff``: five adjacent train views of the object written as
    an LLFF capture (``tools/synthetic_blender.py:write_llff_from_blender``,
    the helper the CPU test uses), OBJ_LLFF_STEPS steps of the CLI at a
    copy of ``fern.txt`` (NDC, 64 + 64 samples), then its test view
    rendered by ``--render_only --render_test``."""
    from intrinsicnerf_tpu_torch import train_object
    from intrinsicnerf_tpu_torch.config import from_object_txt
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.tools.synthetic_blender import write_llff_from_blender

    work = od["work"]
    llff_dir = os.path.join(work, "llff")
    n_views = write_llff_from_blender(od["data_dir"], llff_dir, views=range(5), factor=8)
    cfg_path = object_txt(OBJ_LLFF_CONFIG, work, llff_dir, "fern", OBJ_LLFF_STEPS,
                          i_print=OBJ_LLFF_STEPS, i_weights=OBJ_LLFF_STEPS, i_testset=10 ** 9)
    cfg = from_object_txt(cfg_path)
    data = train_object.load_object_data(cfg)
    ndc_focal = train_object.ndc_focal_for(cfg, data)
    counters = (fm.fused_mlp_forward, fm.fused_mlp_backward)
    for c in counters:
        c.launches = c.captured = 0
    t0 = time.perf_counter()
    train_object.main(["--config", cfg_path, "--no_progress", "--device", dev.type])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    run_dir = cfg.experiment.save_dir
    sc = read_scalars(os.path.join(run_dir, "tfb_logs", "scalars.csv"))
    last = {k[11:]: v[OBJ_LLFF_STEPS] for k, v in sc.items()
            if k.startswith("Train/Loss/") and OBJ_LLFF_STEPS in v}
    t0 = time.perf_counter()
    train_object.main(["--config", cfg_path, "--render_only", "--render_test", "--no_progress",
                       "--device", dev.type])
    render_s = time.perf_counter() - t0
    rdir = os.path.join(run_dir, f"renderonly_test_{OBJ_LLFF_STEPS:06d}")
    rendered = sorted(f for f in os.listdir(rdir) if f.startswith("rgb_"))
    say("object_llff", views=n_views, h=data.h, w=data.w, focal=f"{data.focal:.4f}",
        ndc_focal=ndc_focal, depth_range=json.dumps(cfg.depth_range),
        train_test=json.dumps([len(data.i_split[0]), len(data.i_split[2])]),
        steps=OBJ_LLFF_STEPS, launches_fwd_bwd=json.dumps(launches), train_s=f"{train_s:.1f}",
        render_s=f"{render_s:.1f}", rendered=json.dumps(rendered),
        last=json.dumps({k: round(v, 5) for k, v in last.items()}))
    if not (ndc_focal is not None and launches[1] == 2 * OBJ_LLFF_STEPS and last
            and all(math.isfinite(v) for v in last.values()) and rendered == ["rgb_000.png"]):
        raise AssertionError(f"the LLFF run: launches {launches}, losses {last}, renders {rendered}")
    return {"launches": launches}


def object_cube_phase(torch, np, dev, card):
    """``object_cube``: ``tools/validate_convergence.py`` at its defaults
    (3,000 steps, 64x64, 60 views) through kernels 1 and 2; the held-out
    PSNR must exceed 20."""
    from intrinsicnerf_tpu_torch.tools import validate_convergence as vc

    zero_launches()
    result = vc.run(device=dev, save_dir=os.path.join(ROOT, "logs", "chip_smoke_cube"))
    launches = run_launches()[0]
    say("object_cube", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                          for k, v in result.items()}, launches=json.dumps(launches),
        floor=vc.PSNR_FLOOR, card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    if not (result["psnr"] > vc.PSNR_FLOOR and result["fused"]
            and launches["bwd"] == 2 * result["steps"]):
        raise AssertionError(f"the cube check failed: {result}, launches {launches}")
    return {**result, "launches": launches}


def ply_colours(np, path):
    """The uchar vertex colours of a binary PLY written by ``write_ply``."""
    raw = open(path, "rb").read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode().splitlines()
    props = [ln.split()[1:] for ln in header if ln.startswith("property") and "list" not in ln]
    n_vert = int(next(ln.split()[-1] for ln in header if ln.startswith("element vertex")))
    dtype = np.dtype([(name, "<f4" if t == "float" else "u1") for t, name in props])
    rec = np.frombuffer(raw[end:end + dtype.itemsize * n_vert], dtype=dtype)
    return np.stack([rec[c] for c in ("red", "green", "blue")], axis=1)


def mesh_phase(torch, np, dev, card, fit_cfg_path, obj_cfg_path):
    """``mesh``: the port's ``extract_mesh`` CLI on the ScanNet fit's
    checkpoint at MESH_GRID^3: kernel 1 launched exactly once per 131,072
    grid points and twice per 4,096-ray chunk of the vertex-colour render;
    a 131,072-point slice of the grid's occupancy against the plain
    version on the host; the PLY read back (vertex and face counts,
    colours); the query's, the marching's and the render's times, the
    query beside its bound.  Then an object mesh from the object fit's
    checkpoint at OBJ_MESH_GRID^3.  The slice held is the grid's query
    chunk with the most occupancies above the level, within KERNEL_TOL of
    its largest occupancy.  A fit of a few hundred steps has a
    soft density, so the level is half the largest occupancy of a
    MESH_PROBE^3 probe of the same bounds, at most the CLI's 0.45."""
    from intrinsicnerf_tpu_torch import extract_mesh
    from intrinsicnerf_tpu_torch.geometry import mesh as gm
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    out = {}
    for name, args, grid in (
            ("scene", ["--config_file", fit_cfg_path], MESH_GRID),
            ("object", ["--config", obj_cfg_path], OBJ_MESH_GRID)):
        path = os.path.join(ROOT, "logs", f"chip_smoke_mesh_{name}.ply")
        cli = [*args, "--grid_dim", str(grid), "--device", dev.type, "--out", path]

        # before the counted run: the level from a coarse probe, and the
        # grid's occupancy on a slice, the card against the plain version
        cfg, trainer = extract_mesh.build_trainer(extract_mesh.parse_args(cli))
        with trainer:
            trainer.maybe_resume()
            model, mcfg = trainer.state.model_fine, trainer.mcfg
            origins = trainer.bundle.rays_test[:, 0, 0:3].cpu().numpy()
        span = max(np.ptp(origins, axis=0).max(), 1.0) * 2.5
        corners = origins.mean(0) + span / 2 * np.array(
            [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
        transform, extents = gm.oriented_bounds(corners)
        voxel = (cfg.depth_range[1] - cfg.depth_range[0]) / cfg.render.n_importance
        probe, _ = gm.query_density_grid(
            model, mcfg, gm.grid_within_bound([-1.0, 1.0], extents, transform, MESH_PROBE)[0],
            voxel)
        level = min(0.45, 0.5 * float(probe.max()))
        pts, _ = gm.grid_within_bound([-1.0, 1.0], extents, transform, grid)
        # the grid's query chunk with the most occupancies above the level
        occ, _ = gm.query_density_grid(model, mcfg, pts, voxel)
        above = [int((occ[s:s + gm.QUERY_CHUNK] > level).sum())
                 for s in range(0, len(pts), gm.QUERY_CHUNK)]
        s0 = int(np.argmax(above)) * gm.QUERY_CHUNK
        occ_k = occ[s0:s0 + gm.QUERY_CHUNK]
        occ_p, _ = gm.query_density_grid(copy.deepcopy(model).to("cpu"), mcfg,
                                         pts[s0:s0 + gm.QUERY_CHUNK], voxel)
        del occ
        err = float(np.abs(occ_k - occ_p).max())
        slice_max, slice_above = float(occ_p.max()), int((occ_p > level).sum())
        macs = network_macs(model)
        ops = model.fused_operands(mcfg)
        pts_dev = torch.as_tensor(pts[:gm.QUERY_CHUNK], device=dev)
        in8 = fm.build_in8(pts_dev[:, None], torch.zeros_like(pts_dev))

        def query_kernels():  # the grid's kernel-1 calls alone
            for s in range(0, len(pts), gm.QUERY_CHUNK):
                fm.fused_mlp_forward(ops, in8[:min(gm.QUERY_CHUNK, len(pts) - s)])

        kernel_ms = cuda_ms(query_kernels, 2, torch)
        flops, nbytes = fused_work(len(pts), macs, ops.wbuf.numel(), ops.bbuf.numel())
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
        del trainer, model, ops, pts_dev, in8
        torch.cuda.empty_cache()

        # the CLI, its launches counted
        times = {}
        zero_launches()
        t0 = time.perf_counter()
        extract_mesh.main([*cli, "--level", f"{level:.6g}"], timings=times)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        eager = run_launches()[0]
        verts, faces = gm.read_ply(path)
        colours = ply_colours(np, path)
        grid_calls = math.ceil(grid ** 3 / gm.QUERY_CHUNK)
        render_calls = 2 * math.ceil(times["render_rays"] / gm.RENDER_CHUNK)
        want = grid_calls + render_calls
        row = {"grid": grid, "points": len(pts), "level": level, "launches": eager,
               "want": want, "vertices": len(verts), "faces": len(faces),
               "query_ms": 1e3 * times["query_s"], "query_kernel_ms": kernel_ms,
               "bound_ms": bound_ms, "march_ms": 1e3 * times["march_s"],
               "render_ms": 1e3 * times["render_s"], "render_rays": times["render_rays"],
               "occupancy_max_abs_err": err, "macs": macs}
        say("mesh", model=name, grid=f"{grid}^3", points=len(pts), seconds=f"{total_s:.1f}",
            level=f"{level:.6g}", probe_max_occupancy=f"{float(probe.max()):.4g}",
            launches=json.dumps(eager), want_fwd=want,
            calls=json.dumps({"grid": grid_calls, "render": render_calls}),
            vertices=len(verts), faces=len(faces),
            colours=json.dumps([int(colours.min()), int(colours.max()),
                                round(float(colours.mean()), 2)]),
            query_ms=f"{row['query_ms']:.1f}", query_kernel_ms=f"{kernel_ms:.2f}",
            query_bound_ms=f"{bound_ms:.2f}", march_ms=f"{row['march_ms']:.1f}",
            marching=times["mesh_backend"], render_ms=f"{row['render_ms']:.1f}",
            write_ms=f"{1e3 * times['write_s']:.1f}",
            occupancy_slice=json.dumps({"first_point": s0, "above_level": slice_above,
                                        "max": round(slice_max, 5), "max_abs_err": err}),
            tol=f"{KERNEL_TOL} x the slice's max",
            ply=os.path.relpath(path, ROOT), card=json.dumps(card),
            clocks=json.dumps(smi(CLOCKS)))
        if not (eager["fwd"] == want and len(verts) == times["render_rays"] and len(faces) > 0
                and faces.max() < len(verts) and np.isfinite(verts).all()
                and len(colours) == len(verts) and colours.max() > 0 and slice_above > 0
                and err <= KERNEL_TOL * slice_max):
            raise AssertionError(f"the {name} mesh: launches {eager} (want {want}), "
                                 f"{len(verts)} vertices, {len(faces)} faces, occupancy slice "
                                 f"{slice_above} above the level, max {slice_max}, error {err}")
        out[name] = row
        torch.cuda.empty_cache()
    return out

def bench_phase(torch, card):
    """``tools/bench.py`` at one step per call and at GRAPH_K, in this
    process (its kernels already built); each prints its JSON line."""
    from intrinsicnerf_tpu_torch.tools import bench

    out = {}
    for k in (1, GRAPH_K):
        result = bench.main(["--steps_per_call", str(k)])
        if not (math.isfinite(result["value"]) and math.isfinite(result["last_total"])):
            raise AssertionError(f"the bench at {k} steps per call: {result}")
        out[k] = result
        torch.cuda.empty_cache()
    say("bench", rays_per_s=json.dumps({k: round(r["value"], 1) for k, r in out.items()}),
        ms_per_step=json.dumps({k: round(r["ms_per_step"], 3) for k, r in out.items()}),
        card=json.dumps(card))
    return out


# the endurance tool's rig: the smoke cadences (log 200, checkpoint and
# rebuild 400, eval 1000) for 2000 steps, killed past step 1100
FULLRUN_RIG = ["--smoke", "--steps", "2000", "--kill-at", "1100"]
FULLRUN_KERNELS = ("fused_mlp_fwd", "fused_mlp_fwd_image", "fused_mlp_bwd")


def fullrun_rig_phase(card):
    """``fullrun_rig``: ``tools/fullrun.py`` at the smoke cadences, on the
    card: the scene CLI SIGKILLed past step 1100 and relaunched.  Every
    check of the smoke run must hold, the relaunch must resume the newest
    checkpoint the kill left with the newest complete palette no newer
    than it (800 or 1200, by where the kill landed), and each segment's
    log must count launches of kernel 1, its image and kernel 2."""
    work = os.path.join(ROOT, "logs", "chip_smoke_fullrun")
    shutil.rmtree(work, ignore_errors=True)
    out = os.path.join(work, "FULLRUN_smoke.json")
    t0 = time.perf_counter()
    run_port(["-m", "intrinsicnerf_tpu_torch.tools.fullrun", *FULLRUN_RIG, "--workdir", work,
              "--out", out], timeout=900)
    secs = time.perf_counter() - t0
    with open(out) as f:
        r = json.load(f)
    launches = [seg["launches"] for seg in r["segments"]]
    say("fullrun_rig", seconds=f"{secs:.1f}", wall_s=r["wall_s"],
        killed_at_logged_step=r["killed_at_logged_step"], at_kill=json.dumps(r["at_kill"]),
        resumed_from=json.dumps(r["resumed_from_steps"]),
        palette_from=json.dumps(r["palette_restored_from"]),
        resume_consistent=r["resume_consistent"], checks=json.dumps(r["checks"]),
        segment_launches=json.dumps(launches),
        ms_per_step=json.dumps([seg["ms_per_step_median"] for seg in r["segments"]]),
        rebuild_s=json.dumps([seg["rebuild_s"] for seg in r["segments"]]),
        eval_s=json.dumps([seg["eval_s"] for seg in r["segments"]]),
        final_eval=json.dumps(r["final_eval"]), card=json.dumps(card))
    if not (r["pass"] and r["resume_consistent"] and r["killed_at_logged_step"] >= 1100
            and r["resumed_from_steps"] and r["resumed_from_steps"][0] in (800, 1200)
            and len(launches) == 2
            and all(seg[k] > 0 for seg in launches for k in FULLRUN_KERNELS)):
        raise AssertionError(f"the fullrun rig failed: {r['checks']}, resume "
                             f"{r['resumed_from_steps']} / {r['palette_restored_from']} after "
                             f"{r['at_kill']}, launches {launches}")
    return {"launches": launches, "seconds": secs, "json": r}


def scaling_phase(torch, card, bench_k):
    """``scaling``: ``tools/bench_scaling.py``'s world-1 row on the card (a
    one-rank NCCL group in a process of its own, 8 steps a replay) against
    ``tools/bench.py``'s K = 8 number from ``bench_phase``: 8 + 8
    all-reduces a replay, and no NCCL kernel at one rank."""
    from intrinsicnerf_tpu_torch.tools import bench_scaling

    torch.cuda.empty_cache()
    result = bench_scaling.main(["--ranks", "1"])
    row = result["results"][1]
    ratio = row["global_rays_per_s"] / bench_k["value"]
    say("scaling", world=1, rays_per_s=f"{row['global_rays_per_s']:.1f}",
        ms_per_step=f"{row['ms_per_step']:.4f}", bench_rays_per_s=f"{bench_k['value']:.1f}",
        ratio_to_bench=f"{ratio:.4f}",
        collectives_per_replay=json.dumps(row["collective_calls_per_replay"]),
        nccl_device_ms_per_step=row["nccl_device_ms_per_step"], backend=row["backend"],
        card=json.dumps(card))
    if not (row["backend"] == "nccl" and math.isfinite(row["last_total"])
            and row["collective_calls_per_replay"] == {"reduce_grads": GRAPH_K,
                                                        "reduce_terms": GRAPH_K}
            and row["nccl_device_ms_per_step"] == 0.0):
        raise AssertionError(f"the world-1 scaling row: {row}")
    return {"row": row, "ratio_to_bench": ratio}


_IMPORT_VIEW_RUNNER = """
import json, sys, torch
from intrinsicnerf_tpu_torch import train_scene
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.train.trainer import render_views
cfg_path, rays_path, out_path, frames, split, h, w = sys.argv[1:8]
args = train_scene.parse_args(["--config_file", cfg_path, "--total_frames", frames,
                               "--split_step", split])
cfg, _, trainer = train_scene.build_trainer(args)
with trainer as t:
    step = t.maybe_resume()
    for c in fm.LAUNCH_COUNTERS.values():
        c.launches = c.captured = 0
    st = t.state
    view = next(render_views(st.model_coarse, st.model_fine, t.mcfg, cfg.render,
                             torch.load(rays_path).cuda(), int(h), int(w), cfg.chunk))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in fm.LAUNCH_COUNTERS.items()}
torch.save({"view": view, "step": step, "launches": launches}, out_path)
print(json.dumps({"step": step, "launches": launches}))
"""


def import_cli_phase(torch, np, dev, card, scene):
    """``import_cli``: the graphed scene run's newest checkpoint written as
    a reference-format ``.ckpt`` (the reference's keys only), imported by
    ``python -m intrinsicnerf_tpu_torch.import_reference_ckpt`` at a copy
    of the Replica config, resumed in a second process by the scene CLI's
    trainer, which renders one 320x240 view; the same view rendered here
    from the run's own checkpoint must be bitwise equal, map for map, and
    both go through kernel 1 (twice per 32,768-ray chunk)."""
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.core.rays import create_rays
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer, checkpoint_path, latest_step
    from intrinsicnerf_tpu_torch.train.prepare import replica_intrinsics
    from intrinsicnerf_tpu_torch.train.step import create_train_state
    from intrinsicnerf_tpu_torch.train.trainer import render_views

    work = os.path.join(ROOT, "logs", "chip_smoke_import")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt_dir = os.path.join(scene["save_dir"], "checkpoints")
    step = latest_step(ckpt_dir)
    own = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu")
    ref = os.path.join(work, f"{step:06d}.ckpt")
    torch.save({k: own[k] for k in ("global_step", "network_coarse_state_dict",
                                    "network_fine_state_dict")} | {"optimizer_state_dict": {}},
               ref)
    cfg_path = scene_yaml(CONFIG, os.path.join(work, "cfg.yaml"), {
        "experiment.dataset_dir": scene["data_dir"],
        "experiment.save_dir": os.path.join(work, "run")})
    t0 = time.perf_counter()
    told = run_port(["-m", "intrinsicnerf_tpu_torch.import_reference_ckpt", ref,
                     "--config_file", cfg_path]).strip().splitlines()[-1]
    import_s = time.perf_counter() - t0
    cfg = from_yaml(cfg_path)
    _, test_ids = default_replica_split(SCENE_FRAMES, SCENE_SPLIT)
    traj = np.loadtxt(os.path.join(scene["data_dir"], "traj_w_c.txt")).reshape(-1, 4, 4)
    pose = torch.as_tensor(traj[test_ids[0]], dtype=torch.float32, device=dev)
    rays = create_rays(pose[None], H, W, *replica_intrinsics(W, H), *cfg.depth_range,
                       convention=cfg.experiment.convention)
    rays_path, out_path = os.path.join(work, "rays.pt"), os.path.join(work, "view.pt")
    torch.save(rays.cpu(), rays_path)
    t0 = time.perf_counter()
    run_port(["-c", _IMPORT_VIEW_RUNNER, cfg_path, rays_path, out_path, str(SCENE_FRAMES),
              str(SCENE_SPLIT), str(H), str(W)])
    resume_s = time.perf_counter() - t0
    theirs = torch.load(out_path, weights_only=False)
    # the view from the model the file came from: the run's own checkpoint
    n_cls = own["network_coarse_state_dict"]["semantic_linear.1.weight"].shape[0]
    mcfg = dataclasses.replace(cfg.mlp, num_semantic_classes=n_cls)
    state = create_train_state(mcfg, cfg.train, device=dev)
    Checkpointer(ckpt_dir).restore(state, step)
    zero_launches()
    mine = next(render_views(state.model_coarse, state.model_fine, mcfg, cfg.render, rays, H, W,
                             cfg.chunk, device=dev))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in fm.LAUNCH_COUNTERS.items()}
    want = {"fused_mlp_fwd": 2 * math.ceil(H * W / cfg.chunk), "fused_mlp_fwd_image": 2,
            "fused_mlp_bwd": 0}
    same_maps = {k: bool(np.array_equal(mine[k], theirs["view"][k])) for k in mine}
    acc = float(mine["acc"].mean())
    say("import_cli", step=step, told=json.dumps(told), import_s=f"{import_s:.1f}",
        resume_process_s=f"{resume_s:.1f}", bitwise=json.dumps(same_maps),
        launches_here=json.dumps(launches), launches_resumed=json.dumps(theirs["launches"]),
        mean_opacity=f"{acc:.4f}", card=json.dumps(card))
    if not (theirs["step"] == step and all(same_maps.values()) and launches == want
            and theirs["launches"] == want and acc > VIEW_ACC_FLOOR):
        raise AssertionError(f"the imported checkpoint's view: step {theirs['step']} (want "
                             f"{step}), bitwise {same_maps}, launches {launches} / "
                             f"{theirs['launches']} (want {want}), mean opacity {acc}")
    return {"launches": theirs["launches"], "launches_here": launches}


def kernel_bench_phase(card):
    """``kernel_bench``: one run of ``tools/kernel_bench.py`` (kernels 1
    and 2 alone at 65,536 and 196,608 points, the graphed step), each time
    beside its bound."""
    from intrinsicnerf_tpu_torch.tools import kernel_bench

    r = kernel_bench.main(["--iters", "20"])
    for label, row in r["kernels"].items():
        say("kernel_bench", entry=label, points=row["points"], fwd_ms=f"{row['fwd_ms']:.4f}",
            fwd_bound_ms=f"{row['fwd_bound_ms']:.4f}", fwd_bwd_ms=f"{row['fwd_bwd_ms']:.4f}",
            fwd_bwd_bound_ms=f"{row['fwd_bwd_bound_ms']:.4f}", card=json.dumps(card))
    st = r["step"]
    say("kernel_bench", entry="graphed_step", ms_per_step=f"{st['ms_per_step']:.4f}",
        bound_ms=f"{st['bound_ms']:.4f}", card=json.dumps(card))
    times = [v for row in r["kernels"].values() for v in (row["fwd_ms"], row["fwd_bwd_ms"])]
    if not (all(math.isfinite(t) and t > 0 for t in times + [st["ms_per_step"]])
            and math.isfinite(st["last_total"])):
        raise AssertionError(f"kernel_bench: {r}")
    return r


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.core.rays import create_rays
    from intrinsicnerf_tpu_torch.core.sampling import stratified_z_vals
    from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP
    from intrinsicnerf_tpu_torch.ops import build
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.render.pipeline import render_rays_chunked
    from intrinsicnerf_tpu_torch.tools import fwd_ablate
    from intrinsicnerf_tpu_torch.train.trainer import render_views

    # fp32 matmuls in full fp32; the plain fused version rounds its
    # operands to bf16 first, so its products are exact either way
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the device
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    say("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, card=json.dumps(card),
        clocks=json.dumps(smi(CLOCKS)))

    # 2. the kernel builds, one nvcc per kernel, all started together, and
    # beside them kernel 1's ablation variants
    t0 = time.perf_counter()
    names = ("fused_mlp_fwd", "fused_mlp_bwd", "fwd_probe")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        variants = pool.submit(fwd_ablate.build_variants, list(fwd_ablate.PATCHES),
                               [fwd_ablate.SOURCE])
        builds = list(pool.map(build.build, names))
        ablate_libs = variants.result()
    for name, (_, secs, log) in zip(names, builds):
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        say("build", kernel=name, seconds=f"{secs:.1f}", ptxas=json.dumps(" | ".join(info)))
    say("build", total_seconds=f"{time.perf_counter() - t0:.1f}")

    # the configuration, as a user loads it
    fc = from_yaml(CONFIG)
    mcfg = dataclasses.replace(fc.mlp, num_semantic_classes=N_CLASSES)
    rcfg, chunk = fc.render, fc.chunk
    if not (mcfg.use_fused_kernel and (mcfg.depth, mcfg.width) == (8, 256)):
        raise AssertionError(f"{CONFIG} no longer selects the fused 8x256 model: {mcfg}")
    if (fc.train.n_rays, rcfg.n_coarse, rcfg.n_importance, rcfg.perturb,
            rcfg.raw_noise_std) != (512, 64, 128, 1.0, 1.0):
        raise AssertionError(f"{CONFIG} no longer sets the Replica training step: {fc}")
    model_c = IntrinsicMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(1))
    model_f = IntrinsicMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(2))
    c2w = torch.eye(4, device=dev)
    c2w[:3, 3] = torch.tensor([0.3, -0.2, -1.0])
    near, far = fc.depth_range
    # Replica's 90-degree field of view: f = W / 2
    rays = create_rays(c2w, H, W, W / 2, W / 2, (W - 1) / 2, (H - 1) / 2, near, far)
    n_rays = rays.shape[1]

    # 3. kernel vs plain at the main path's shapes
    ops = model_c.fused_operands(mcfg)
    # kernel 1's weight image: the card's against the plain version's bytes
    img_plain = fm.fwd_weight_image_plain(ops.wbuf)
    img_card = fm.fwd_weight_image(ops.wbuf)
    torch.cuda.synchronize()
    img_same = torch.equal(img_card.view(torch.int16), img_plain.view(torch.int16)) and \
        torch.equal(ops.wimg.view(torch.int16), img_plain.view(torch.int16))
    img_ms = cuda_ms(lambda: fm.fwd_weight_image(ops.wbuf), 20, torch)
    img_plain_ms = cuda_ms(lambda: fm.fwd_weight_image_plain(ops.wbuf), 5, torch)
    img_bound_ms = 1e3 * 2 * 2 * ops.wbuf.numel() / PEAK_BYTES  # bf16 read once, written once
    image = dict(ms=img_ms, plain_ms=img_plain_ms, bound_ms=img_bound_ms, bound_by="bytes")
    say("image_vs_plain", elems=ops.wbuf.numel(), bitwise=img_same, ms=f"{img_ms:.4f}",
        plain_ms=f"{img_plain_ms:.4f}", bound_ms=f"{img_bound_ms:.4f}", bound_by="bytes",
        card=json.dumps(card))
    if not img_same:
        raise AssertionError("kernel 1's weight image on the card differs from the plain one")
    del img_plain, img_card
    # the network's multiply-adds per point, and the kernel's in its
    # padded packed layout (the difference is work the kernel wastes)
    macs = network_macs(model_c)
    padded_macs = ops.wbuf.numel()
    say("work", macs_per_point=macs, padded_macs_per_point=padded_macs,
        padded_share_wasted=f"{1 - macs / padded_macs:.4f}")
    r0 = rays[0, :chunk]
    z = stratified_z_vals(r0[:, 6:7], r0[:, 7:8], rcfg.n_coarse)
    pts = r0[:, None, 0:3] + r0[:, None, 3:6] * z[..., None]
    in8_coarse = fm.build_in8(pts, r0[:, 8:11])  # one coarse chunk, 32768 x 64
    n_fine = chunk * (rcfg.n_coarse + rcfg.n_importance)
    reps = -(-n_fine // in8_coarse.shape[0])
    in8_fine = in8_coarse.repeat(reps, 1)[:n_fine]  # the fine chunk's size, 32768 x 192
    # the training step's shapes (1,024 rays at 64 and 192 samples), a
    # ragged count, and sizes below, at and just past a tile
    cases = (("n1", in8_coarse[:1]), ("n64", in8_coarse[:64]), ("n4097", in8_coarse[:4097]),
             ("coarse_step", in8_coarse[:65_536]), ("ragged", in8_coarse[:100_003]),
             ("fine_step", in8_coarse[:196_608]), ("coarse_chunk", in8_coarse),
             ("fine_chunk", in8_fine))
    slices = {"sigma": (0, 1), "albedo": (1, 4), "shading": (4, 5), "residual": (5, 8),
              "semantic": (8, 8 + N_CLASSES), "pad": (8 + N_CLASSES, fm.OUT_W)}

    def plain(in8):  # in slices, to bound the plain version's memory
        return torch.cat([fm.fused_mlp_forward_plain(ops.packed, ops.pe, x)
                          for x in in8.split(1 << 21)])

    timing = {}
    max_err = 0.0
    for label, in8 in cases:
        got = fm.fused_mlp_forward(ops, in8)
        again = fm.fused_mlp_forward(ops, in8)
        torch.cuda.synchronize()
        bitwise = torch.equal(got.view(torch.int16), again.view(torch.int16))
        del again
        ref = plain(in8)
        errs = {}
        for sl, (a, b) in slices.items():
            d = (got[:, a:b].float() - ref[:, a:b].float()).abs().max().item()
            scale = max(ref[:, a:b].float().abs().max().item(), 1.0)
            errs[sl] = d / scale
            max_err = max(max_err, d)
        ok = (bitwise and all(e < KERNEL_TOL for e in errs.values())
              and torch.isfinite(got.float()).all().item())
        n = in8.shape[0]
        flops, nbytes = fused_work(n, macs, padded_macs, ops.bbuf.numel())
        bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
        k_ms = cuda_ms(lambda: fm.fused_mlp_forward(ops, in8), 5, torch)
        p_ms = cuda_ms(lambda: plain(in8), 2, torch)
        timing[label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        say("kernel_vs_plain", shape=label, points=n, bitwise_repeat=bitwise,
            rel_err=json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}),
            tol=KERNEL_TOL, ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, achieved_tflops=f"{flops / k_ms / 1e9:.1f}", card=json.dumps(card))
        if not ok:
            raise AssertionError(f"fused kernel disagrees with its plain version at {label}: "
                                 f"{errs}, bitwise repeat {bitwise}")
        del got, ref
    del in8_fine, cases

    # kernel 1 with one part cut out at a time, at the fine step and chunk
    ablation = fwd_ablate.time_variants(
        ablate_libs, ops, fwd_ablate.shape_inputs(model_c, fc, dev), 5)
    for row in ablation:
        check = {k: row[k] for k in ("rel_err", "bitwise_repeat") if k in row}
        say("fwd_ablate", variant=row["variant"], points=json.dumps(fwd_ablate.SHAPES),
            ms=json.dumps({k: round(v, 4) for k, v in row["ms"].items()}),
            **check, card=json.dumps(card))
    torch.cuda.empty_cache()

    # 4. the main path: one full view through render_views, of weights
    # loaded just before it (each model builds its weight image once)
    next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))  # warm-up
    for m in (model_c, model_f):
        m.load_state_dict(m.state_dict())
    torch.cuda.synchronize()
    fm.fused_mlp_forward.launches = fm.fused_mlp_backward.launches = 0
    fm.fwd_weight_image.launches = 0
    t0 = time.perf_counter()
    view = next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))
    torch.cuda.synchronize()
    view_ms = 1e3 * (time.perf_counter() - t0)
    launches = fm.fused_mlp_forward.launches
    view_images = fm.fwd_weight_image.launches
    n_chunks = math.ceil(n_rays / chunk)
    want = 2 * n_chunks  # coarse + fine per chunk
    # serving takes no gradient, and builds one weight image per model
    if (launches, fm.fused_mlp_backward.launches, view_images) != (want, 0, 2):
        raise AssertionError(f"the view launched kernel 1 {launches} times (want {want}), "
                             f"kernel 2 {fm.fused_mlp_backward.launches} times (want 0) and "
                             f"the weight image {view_images} times (want 2)")
    shapes = {"rgb": (H, W, 3), "disp": (H, W), "depth": (H, W), "acc": (H, W),
              "albedo": (H, W, 3), "shading": (H, W), "residual": (H, W, 3),
              "sem_label": (H, W), "sem_entropy": (H, W)}
    for k, shape in shapes.items():
        if view[k].shape != shape or not np.isfinite(view[k]).all():
            raise AssertionError(f"view map {k}: shape {view[k].shape} (want {shape}) or not finite")
    # the view's own MLP work: its rays at 64 coarse + 192 fine points, no padding
    view_points = n_rays * (2 * rcfg.n_coarse + rcfg.n_importance)
    view_bound_ms = 1e3 * fused_work(view_points, macs, padded_macs, 0)[0] / PEAK_BF16_FLOPS
    more_ms = []  # a few more views for the spread, outside the counted run
    for _ in range(4):
        t0 = time.perf_counter()
        next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))
        torch.cuda.synchronize()
        more_ms.append(round(1e3 * (time.perf_counter() - t0), 2))
    median_ms = float(np.median([view_ms] + more_ms))
    say("main_path", view=f"{H}x{W}", rays=n_rays, chunk=chunk, launches=launches,
        image_launches=view_images, ms_per_view=f"{view_ms:.2f}",
        more_views_ms=json.dumps(more_ms), median_ms_per_view=f"{median_ms:.2f}",
        rays_per_s=f"{n_rays / median_ms * 1e3:.0f}", bound_ms_per_view=f"{view_bound_ms:.2f}",
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))

    # the last chunk unpadded (the port) against padded to a whole chunk
    # with copies of the last ray (the JAX package's static shapes): the
    # same render of the view's rays, padded by the caller
    pad = (-n_rays) % chunk
    padded = torch.cat([rays[0], rays[0, -1:].expand(pad, rays.shape[-1])])

    def render_ms(r):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            with torch.no_grad():
                render_rays_chunked(model_c, model_f, mcfg, r, rcfg, chunk)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    say("last_chunk", rays=n_rays, padded_rays=n_rays + pad,
        median_ms_unpadded=f"{render_ms(rays[0]):.2f}", median_ms_padded=f"{render_ms(padded):.2f}",
        card=json.dumps(card))
    del padded

    # the view against the plain version on a seeded subset of its rays
    view_vs_plain(torch, np, model_c, model_f, mcfg, rcfg, rays[0], view, 3, "view_vs_plain")

    # where a view's device time goes: one more view under the profiler
    wall_ms, busy_ms, by_name = profile_window(
        lambda: next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev)),
        torch)
    k1_view = sum(v for k, v in by_name.items() if "fused_mlp_fwd_kernel" in k)
    if k1_view <= 0.0:
        raise AssertionError(f"kernel 1 not found among the profiled kernels {sorted(by_name)}")
    say("profile", path="view", wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", kernel_ms_per_view=f"{k1_view:.2f}",
        kernel1_share=f"{k1_view / busy_ms:.3f}", top_kernels_ms=json.dumps(top(by_name)),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    del model_c, model_f
    torch.cuda.empty_cache()

    train = train_phases(torch, np, fc, mcfg, dev, card, macs, rays)
    probe = probe_phases(torch, np, dev, card, builds[names.index("fwd_probe")][2])
    scene = scene_phases(torch, np, dev, card)
    scene_k = scene_phases(torch, np, dev, card, SCENE_K, train["graph"]["eager_bitwise"], scene)
    edit_phase(torch, np, dev, card, scene_k["save_dir"])
    bench = bench_phase(torch, card)
    scaling = scaling_phase(torch, card, bench[GRAPH_K])
    kbench = kernel_bench_phase(card)
    imported = import_cli_phase(torch, np, dev, card, scene_k)
    room = scene_k["data_dir"]
    dp = data_parallel_phase(torch, np, dev, card, room)
    sd = scannet_data_phase(torch, np, dev, card, room)
    sst = scannet_step_phase(torch, np, dev, card, sd)
    del sd["bundle"]
    torch.cuda.empty_cache()
    sfit = scannet_fit_phase(torch, np, dev, card, sd)
    allim = scene_all_images_phase(torch, np, dev, card, room)
    nyu = replica_nyu_phase(torch, np, dev, card, room)
    degr = degradations_phase(torch, np, dev, card, room)
    od = object_data_phase(torch, np, dev, card)
    ost = object_step_phase(torch, np, dev, card, od)
    ograph = object_graph_phase(torch, np, dev, card, od, ost)
    oview = object_view_phase(torch, np, dev, card, od, ost)
    okern = ost["kernels"]
    del ost
    torch.cuda.empty_cache()
    ofit = object_fit_phase(torch, np, dev, card, od)
    object_llff_phase(torch, np, dev, card, od)
    obj_cfg_path = od["cfg_path"]
    del od
    torch.cuda.empty_cache()
    ocube = object_cube_phase(torch, np, dev, card)
    mesh = mesh_phase(torch, np, dev, card, sfit["cfg_path"], obj_cfg_path)
    torch.cuda.empty_cache()
    fullrun = fullrun_rig_phase(card)

    def new_paths(name):
        """The launches of kernel ``name`` on the paths of the last tools
        (each counted in its own processes)."""
        return {"launches_fullrun_rig_segments": [seg[name] for seg in fullrun["launches"]],
                "launches_import_cli_resumed_view": imported["launches"][name]}

    # the other scene data's paths: launches per run, and kernels 1 and 2 at
    # each semantic width beside their bounds at the network's own work
    def widths(part):
        return {c: {call: sst["kernels"][c][call][part] for call in ("coarse", "fine")}
                for c in sst["kernels"]}

    def scene_data(part):
        return {"launches_scannet_step_phase": sst["launches"][part],
                "launches_scannet_fit": sfit["launches"][part],
                "launches_all_images_cli": allim["launches"][part],
                "launches_replica_nyu_cli": nyu["launches"][part],
                "launches_degradations": {k: v["launches"][part] for k, v in degr.items()},
                "launches_mesh": {k: v["launches"][part] for k, v in mesh.items()}}

    t = timing["coarse_chunk"]
    b = train["bwd_timing"]["fine_step"]
    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fused_mlp_fwd.cu",
        "replaces": "intrinsicnerf_tpu/ops/fused_mlp.py:346",
        # the graphed scene run: eager launches (renders, probes, the capture's
        # warm-up step) + replays x 2 x steps per call (train_graph's profiled
        # replay finds them by name)
        "launches": scene_k["launches"]["fwd"],
        "launches_scene_one_step_per_call": scene["launches"]["fwd"],
        "launches_train_step_phase": train["launches"]["fwd"],
        "launches_per_graph_replay": train["graph"]["replay_kernels"]["fused_mlp_fwd_kernel"],
        "launches_per_step": train["launches"]["fwd"] // TIMED_STEPS,
        "launches_per_view": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],  # one coarse chunk of the view (2,097,152 points)
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this MLP
        "ms_step_coarse": timing["coarse_step"]["ms"],
        "ms_step_fine": timing["fine_step"]["ms"],
        "ms_fine_chunk": timing["fine_chunk"]["ms"],
        "bound_ms_step_coarse": timing["coarse_step"]["bound_ms"],
        "bound_ms_step_fine": timing["fine_step"]["bound_ms"],
        "bound_ms_fine_chunk": timing["fine_chunk"]["bound_ms"],
        "ms_per_step_call": train["fwd_step_ms"],
        "ablation_ms": {row["variant"]: row["ms"] for row in ablation},
        # the object path (lego config, semantic head off): its CLI run, one
        # 400x400 view, the cube check; the step's calls against their bounds
        # at the object network's 659,456 multiply-adds per point
        "launches_object_fit": ofit["launches"]["fwd"],
        "launches_object_view": oview["launches"],
        "launches_object_cube": ocube["launches"]["fwd"],
        "object_step": {k: okern[k]["fwd"] for k in ("coarse", "fine")},
        "object_view": {"median_ms": oview["median_ms"], "bound_ms": oview["bound_ms"]},
        # the other scene data (ScanNet C = the scan's, NYU-40, NYU-13) and the mesh grid
        "semantic_widths": widths("fwd"),
        "max_abs_err_semantic_widths": max(v["max_fwd_err"] for v in sst["kernels"].values()),
        "mesh_grid": {k: {f: v[f] for f in ("points", "query_kernel_ms", "query_ms",
                                             "bound_ms", "occupancy_max_abs_err")}
                      for k, v in mesh.items()},
        "scannet_view": sfit["view"],
        "launches_scannet_view": sfit["view"]["launches"],
        **scene_data("fwd"),
        # the data-parallel phase (one NCCL rank): its graphed steps, split view and CLI run
        "launches_data_parallel": dp["launches"]["fwd"],
        "launches_data_parallel_parts": {k: v["fwd"] for k, v in dp["parts"].items()},
        **new_paths("fused_mlp_fwd"),
        "kernel_bench": {k: {f: v[f] for f in ("points", "fwd_ms", "fwd_bound_ms")}
                         for k, v in kbench["kernels"].items()},
    }, {
        "name": "fused_mlp_fwd_image",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fused_mlp_fwd.cu",
        "replaces": "intrinsicnerf_tpu/ops/fused_mlp.py:451",  # _run_fwd's resident weights
        "launches": scene_k["launches"]["image"],  # 2 per step, 2 per set of weights rendered
        "launches_scene_one_step_per_call": scene["launches"]["image"],
        "launches_per_view": view_images,
        "max_abs_err": 0.0,  # bitwise
        "ms": image["ms"],
        "plain_ms": image["plain_ms"],
        "bound_ms": image["bound_ms"],
        "bound_by": image["bound_by"],
        "library_ms": None,  # no single PyTorch call lays out the slabs
        "launches_object_fit": ofit["launches"]["image"],
        **scene_data("image"),
        "launches_data_parallel": dp["launches"]["image"],
        **new_paths("fused_mlp_fwd_image"),
    }, {
        "name": "fused_mlp_bwd",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        "replaces": "intrinsicnerf_tpu/ops/fused_mlp.py:354",
        "launches": scene_k["launches"]["bwd"],  # the graphed scene run: 2 per step
        "launches_scene_one_step_per_call": scene["launches"]["bwd"],
        "launches_train_step_phase": train["launches"]["bwd"],
        "launches_per_graph_replay": train["graph"]["replay_kernels"]["bwd_act_wgmma_kernel"],
        "launches_per_step": train["launches"]["bwd"] // TIMED_STEPS,
        "max_abs_err": train["bwd_max_err"],
        "ms": b["ms"],  # the step's fine call (196,608 points)
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this MLP's gradient
        "arena_floor_ms": b["arena_floor_ms"],  # the arena written and read once
        "pass_ms": b["pass_ms"],  # the fine call's passes: activations, weight GEMM, reductions
        "pass_bound_ms": b["pass_bound_ms"],
        "per_shape": train["bwd_timing"],
        "launches_object_fit": ofit["launches"]["bwd"],
        "launches_object_cube": ocube["launches"]["bwd"],
        "object_step": {k: okern[k]["bwd"] for k in ("coarse", "fine")},  # 131,072 / 393,216
        "semantic_widths": widths("bwd"),
        "max_abs_err_semantic_widths": max(v["max_bwd_err"] for v in sst["kernels"].values()),
        **{k: v for k, v in scene_data("bwd").items() if k != "launches_mesh"},
        "launches_data_parallel": dp["launches"]["bwd"],
        "launches_data_parallel_parts": {k: v["bwd"] for k, v in dp["parts"].items()},
        **new_paths("fused_mlp_bwd"),
        # kernel 1's image, kernel 1 and kernel 2 of the packed state's forward and backward
        "kernel_bench_fwd_bwd": {k: {f: v[f] for f in ("points", "fwd_bwd_ms", "fwd_bwd_bound_ms")}
                                 for k, v in kbench["kernels"].items()},
        "kernel_bench_graphed_step": {f: kbench["step"][f] for f in ("ms_per_step", "bound_ms")},
        "scaling_world1": {"rays_per_s": scaling["row"]["global_rays_per_s"],
                           "ratio_to_bench": scaling["ratio_to_bench"]},
    }, {
        "name": "fwd_probe",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fwd_probe.cu",
        "replaces": "tools_fwd_probe.py:47",
        "launches": probe["launches"],  # the probe CLI's sweep
        "max_abs_err": probe["max_err"],
        "ms": probe["ms"],  # 8 layers, full, 196,608 points, bf16 out, 64-point tiles
        "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"],
        "bound_by": probe["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the probe
        "ms_tile128": probe["ms_tile128"],
        "ms_per_layer": probe["ms_per_layer"],  # least squares over 1..16 layers, per tile
        "library_ms_per_layer": probe["library_ms_per_layer"],  # one bf16 torch.matmul layer
        "registers": probe["registers"],
        "spill_bytes": probe["spill_bytes"],
    }, {
        "name": "fwd_probe_image",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fwd_probe.cu",
        "replaces": "tools_fwd_probe.py:105",  # the probe's weights resident in VMEM
        "launches": probe["image_launches"],  # the probe CLI's sweep: one per case
        "max_abs_err": 0.0,  # bitwise
        "ms": probe["image"]["ms"],  # 16 layers
        "plain_ms": probe["image"]["plain_ms"],
        "bound_ms": probe["image"]["bound_ms"],
        "bound_by": probe["image"]["bound_by"],
        "library_ms": None,  # no single PyTorch call lays out the slabs
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
