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

- serving: one full 320x240 view through ``render_views`` (32,768-ray
  chunks), which must go through kernel 1 and agree with the plain
  version on a subset of its rays;
- training: ``train/step.py:make_train_step`` at 512 pairs per step on
  four synthetic 320x240 views, which must launch kernels 1 and 2 twice
  each per step, keep every loss term finite, move the parameters,
  lower the loss on a fixed batch, and agree with the same step run by
  the plain versions on the host;
- the forward probe (kernel 3, ``tools/fwd_probe.py``): every case of
  its sweep (each variant, tile, layer count and output type) and a
  ragged point count, each held against its plain version first, then
  the sweep itself;
- the scene trainer (``train/trainer.py:Trainer``, as the scene CLI runs
  it) on a synthetic room written by ``tools_make_synthetic_replica.py``:
  an evaluation, 400 steps with two cluster rebuilds, a checkpoint and
  an evaluation, then a resume in a second trainer that must restore the
  step, the parameters, the Adam state and the palette exactly and
  train on.

Each path runs with the launch counts set to 0 just before it and read
just after.  It prints what it measured; the last line is ``{"ok":
true, "device": {...}}``, and any failed phase exits non-zero and prints
no such line.  It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
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
SLICE_PAIRS = 64  # pairs of the step run on both the card and the host
CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


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


def profile_window(fn, torch, host=None):
    """(wall ms, device busy ms, {kernel name: device ms}) of one call of
    ``fn`` under torch.profiler; with ``host`` a dict, it also receives
    {host op: self CPU ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
        elif host is not None and e.device_type == DeviceType.CPU:
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / 1e3
    return wall_ms, sum(by_name.values()), by_name


def top(by_name, n=8):
    """The ``n`` largest entries, names cut short (template arguments make them long)."""
    cut = {}
    for k, v in by_name.items():
        cut[k[:60]] = cut.get(k[:60], 0.0) + v
    return {k: round(v, 3) for k, v in sorted(cut.items(), key=lambda kv: -kv[1])[:n]}


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
    from intrinsicnerf_tpu_torch.train.step import (
        DataPools, TrainState, create_train_state, make_train_step)

    rcfg, tcfg = fc.render, fc.train
    n_rays = 2 * tcfg.n_rays  # pixels and their neighbours
    n_coarse_pts = n_rays * rcfg.n_coarse
    n_fine_pts = n_rays * (rcfg.n_coarse + rcfg.n_importance)

    # the backward's multiply-adds per point, counted on the network's own
    # layers: the forward without the five output products, the weight
    # product of every layer, the input product of every layer whose input
    # depends on parameters (all but the PE-fed w0, w5x and wv_d)
    probe = IntrinsicMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(5))
    lin = dict((n, m) for n, m in probe.named_modules() if isinstance(m, torch.nn.Linear))
    out_macs = sum(lin[n].weight.numel() for n in ("alpha_linear", "albedo_linear2",
                                                    "shading_linear2", "residual_linear",
                                                    "semantic_linear.1"))
    pe_macs = 2 * mcfg.input_ch * mcfg.width + mcfg.input_ch_views * (mcfg.width // 2)
    bwd_macs = (macs - out_macs) + macs + (macs - pe_macs)
    say("work", bwd_macs_per_point=bwd_macs, fwd_recompute=macs - out_macs, weight_products=macs,
        input_products=macs - pe_macs)

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
        bwd_timing[label] = dict(points=n, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
        say("bwd_kernel_vs_plain", shape=label, points=n, bitwise_repeat=bitwise,
            cos=f"{cos:.7f}", rel_err=f"{rel:.3g}",
            worst_block_cos=json.dumps([worst_cos[0], round(worst_cos[1][0], 7)]),
            worst_block_rel=json.dumps([worst_rel[0], float(f"{worst_rel[1][1]:.3g}")]),
            tol=json.dumps({"cos": BWD_COS, "rel": BWD_REL}), ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            achieved_tflops=f"{flops / k_ms / 1e9:.1f}", fwd_kernel_ms=f"{fwd_step_ms[label]:.4f}",
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
    step_ms, host_ms, reports = [], [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        reports.append(step_fn(state, pools, table, w_c, gen))
        host_ms.append(1e3 * (time.perf_counter() - t0))  # the step's work enqueued
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"fwd": fm.fused_mlp_forward.launches, "bwd": fm.fused_mlp_backward.launches}
    want = 2 * TIMED_STEPS  # coarse + fine per step
    if launches != {"fwd": want, "bwd": want}:
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

    def run_on(device):
        mc = copy.deepcopy(state.model_coarse).to(device)
        mf = copy.deepcopy(state.model_fine).to(device)
        opt = torch.optim.Adam(list(mc.parameters()) + list(mf.parameters()), lr=tcfg.lrate)
        st = TrainState(step=state.step, model_coarse=mc, model_fine=mf, optimizer=opt)
        b = RayBatch(*(x.to(device) if torch.is_tensor(x) else x for x in sl))
        dr = {k: (v.to(device) if v is not None else None) for k, v in draws.items()}
        tab = type(table)(*(x.to(device) if torch.is_tensor(x) else x for x in table))
        fn = make_train_step(mcfg, rcfg, tcfg, H, W, sample_fn=lambda g_, p_, s_: b,
                             noise_fn=lambda g_, n_: dr)
        rep = fn(st, None, tab, w_c, None)
        grads = [torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
                 for m in (mc, mf)]
        return {k: float(v) for k, v in rep._asdict().items()}, grads

    fm.fused_mlp_forward.launches = fm.fused_mlp_backward.launches = 0
    rep_k, grads_k = run_on(dev)
    torch.cuda.synchronize()
    slice_launches = (fm.fused_mlp_forward.launches, fm.fused_mlp_backward.launches)
    rep_p, grads_p = run_on("cpu")
    rel = {k: abs(rep_k[k] - rep_p[k]) / max(abs(rep_p[k]), 1e-7) for k in rep_p}
    cos = [float(a @ b / (a.norm() * b.norm())) for a, b in zip(grads_k, grads_p)]
    say("step_vs_plain", pairs=SLICE_PAIRS, launches=json.dumps(slice_launches),
        rel_err=json.dumps({k: float(f"{v:.3g}") for k, v in rel.items()}), tol=STEP_REL,
        grad_cos=json.dumps({"coarse": round(cos[0], 7), "fine": round(cos[1], 7)}),
        cos_tol=STEP_COS)
    if slice_launches != (2, 2) or max(rel.values()) > STEP_REL or min(cos) < STEP_COS:
        raise AssertionError(f"the step on the card disagrees with the plain step: {rel} {cos}")

    # where a step's device time goes
    wall_ms, busy_ms, by_name = profile_window(
        lambda: step_fn(state, pools, table, w_c, gen), torch)
    k1 = sum(v for k, v in by_name.items() if "fused_mlp_fwd_kernel" in k)
    k2 = sum(v for k, v in by_name.items()
             if any(n in k for n in ("bwd_act_kernel", "bwd_wgrad_kernel", "reduce_rows_kernel")))
    say("profile", path="train_step", wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", busy_over_median_step=f"{busy_ms / median:.3f}",
        kernel1_share=f"{k1 / busy_ms:.3f}",
        kernel2_share=f"{k2 / busy_ms:.3f}", kernel1_ms=f"{k1:.3f}", kernel2_ms=f"{k2:.3f}",
        top_kernels_ms=json.dumps(top(by_name)), card=json.dumps(card),
        clocks=json.dumps(smi(CLOCKS)))
    return {"bwd_timing": bwd_timing, "bwd_max_err": bwd_max_err, "launches": launches,
            "fwd_step_ms": fwd_step_ms}


def probe_phases(torch, np, dev, card):
    """Kernel 3 against its plain version, then the probe's own path (the
    sweep of ``tools/fwd_probe.py``) with its launches counted."""
    from intrinsicnerf_tpu_torch.ops import fwd_probe as fp
    from intrinsicnerf_tpu_torch.tools import fwd_probe as probe_cli

    # every case of the sweep (variants, tiles, layer counts, fp32 output),
    # then a ragged point count
    cases = ([(n_layers, v, tile, PROBE_N, out) for n_layers, v, tile, out in probe_cli.SWEEP]
             + [(8, "full", 64, PROBE_RAGGED, torch.bfloat16)])
    max_err, main_case = 0.0, None
    for n_layers, variant, tile, n, out in cases:
        in8, ops = fp.probe_inputs(n_layers, n=n, bias_scale=0.1, device=dev)
        got = fp.fwd_probe(in8, ops, variant, tile, out)
        torch.cuda.synchronize()
        ref = fp.fwd_probe_plain(in8, ops, variant, out)
        d = (got.float() - ref.float()).abs().max().item()
        rel = d / max(ref.float().abs().max().item(), 1.0)
        max_err = max(max_err, d)
        k_ms = cuda_ms(lambda: fp.fwd_probe(in8, ops, variant, tile, out), 10, torch)
        p_ms = cuda_ms(lambda: fp.fwd_probe_plain(in8, ops, variant, out), 3, torch)
        flops, _ = fp.probe_work(n, n_layers, out)
        bound_ms, bound_by = probe_cli.bound(n, n_layers, out)
        say("probe_vs_plain", layers=n_layers, variant=variant, tile=tile, points=n,
            out="f32" if out == torch.float32 else "bf16", rel_err=f"{rel:.3g}", tol=PROBE_TOL,
            ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, achieved_tflops=f"{flops / k_ms / 1e9:.1f}", card=json.dumps(card))
        if not (rel < PROBE_TOL and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"kernel 3 disagrees with its plain version at "
                                 f"{(n_layers, variant, tile, n, out)}: {rel}")
        if (n_layers, variant, tile, n, out) == (8, "full", 64, PROBE_N, torch.bfloat16):
            main_case = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        del in8, ops, got, ref

    # the probe's own path: its CLI's sweep, launches counted
    fp.fwd_probe.launches = 0
    sweep = [probe_cli.run_case(n_layers, v, tile, out, PROBE_N, dev, 20)
             for n_layers, v, tile, out in probe_cli.SWEEP]
    launches = fp.fwd_probe.launches
    for r in sweep:
        say("probe_sweep", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in r.items()},
            card=json.dumps(card))
    want = len(probe_cli.SWEEP) * (4 + 20)  # warm-up and timed calls per case
    say("probe_sweep", launches=launches, want=want,
        cublas_layer_ms=f"{probe_cli.cublas_layer_ms(PROBE_N, dev, 20):.4f}")
    if launches != want:
        raise AssertionError(f"the probe sweep launched kernel 3 {launches} times, want {want}")
    torch.cuda.empty_cache()
    return {"max_err": max_err, "launches": launches, **main_case}


def read_scalars(path):
    """{name: {step: value}} from a trainer's ``scalars.csv``."""
    import csv

    out = {}
    with open(path) as f:
        for step, name, val in csv.reader(f):
            out.setdefault(name, {})[int(step)] = float(val)
    return out


def scene_phases(torch, np, dev, card):
    """The scene trainer on a synthetic room at the Replica config: an
    evaluation, ``SCENE_STEPS`` steps with two rebuilds, a checkpoint and
    an evaluation; then a resume in a second trainer."""
    import shutil

    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.data.replica import default_replica_split, load_replica
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
    from intrinsicnerf_tpu_torch.tools.synthetic_replica import write_synthetic_replica
    from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer
    from intrinsicnerf_tpu_torch.train.prepare import prepare_replica_bundle
    from intrinsicnerf_tpu_torch.train.trainer import Trainer

    work = os.path.join(ROOT, "logs", "chip_smoke_scene")
    shutil.rmtree(work, ignore_errors=True)
    data_dir, save_dir = os.path.join(work, "data"), os.path.join(work, "run")
    t0 = time.perf_counter()
    report = write_synthetic_replica(data_dir, SCENE_FRAMES, W, H)
    data_s = time.perf_counter() - t0
    overrides = {"experiment.dataset_dir": data_dir, "experiment.save_dir": save_dir,
                 "train.N_iters": SCENE_STEPS,
                 **{f"logging.{k}": v for k, v in SCENE_CADENCE.items()}}
    cfg = from_yaml(CONFIG, overrides)
    train_ids, test_ids = default_replica_split(SCENE_FRAMES, SCENE_SPLIT)
    data = load_replica(data_dir, train_ids, test_ids, img_h=cfg.experiment.height,
                        img_w=cfg.experiment.width)
    bundle = prepare_replica_bundle(cfg, data, device=dev)
    n_train, n_test = len(train_ids), len(test_ids)
    say("scene_data", tool=json.dumps(report), seconds=f"{data_s:.1f}", train_views=n_train,
        test_views=n_test, classes=bundle.num_valid_classes, view=f"{H}x{W}")

    steps = []  # (step, enqueue ms, step ms, did periodic work)

    def hook(done, t_start, t_enqueued, did_work):
        torch.cuda.synchronize()
        steps.append((done, 1e3 * (t_enqueued - t_start),
                      1e3 * (time.perf_counter() - t_start), did_work))
        if done % SCENE_CADENCE["step_vis_train"] == 0:
            rebuilds.append(dict(trainer.last_rebuild))

    rebuilds = []
    trainer = Trainer(cfg, bundle, seed=0, device=dev)
    trainer.step_hook = hook
    fm.fused_mlp_forward.launches = fm.fused_mlp_backward.launches = 0
    t0 = time.perf_counter()
    m0 = trainer.evaluate(0)
    eval_s = time.perf_counter() - t0
    report_last = trainer.fit(progress=False)
    torch.cuda.synchronize()
    launches = {"fwd": fm.fused_mlp_forward.launches, "bwd": fm.fused_mlp_backward.launches}
    state_after = [p.detach().clone() for m in (trainer.state.model_coarse,
                                                trainer.state.model_fine) for p in m.parameters()]
    opt_after = copy.deepcopy(trainer.state.optimizer.state_dict())
    table_after = trainer.table
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
    want = {"fwd": 2 * SCENE_STEPS + 2 * chunks * views + 2 * probes, "bwd": 2 * SCENE_STEPS}
    if launches != want:
        raise AssertionError(f"the scene run launched {launches}, want {want}")
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
    plain = [x for x in steps if not x[3]]
    median_ms = float(np.median([x[2] for x in plain]))
    say("scene_fit", steps=SCENE_STEPS, launches=json.dumps(launches), want=json.dumps(want),
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
          and all(term[s] > 0.0 for s in after)
          and len(rebuilds) == 2 and finite and m_end["psnr"] > m0["psnr"] and not missing
          and all(math.isfinite(float(v)) for v in report_last))
    if not ok:
        raise AssertionError("the scene run failed a check (see the scene_fit line)")
    say("scene_time", median_ms_per_plain_step=f"{median_ms:.3f}",
        median_host_enqueue_ms=f"{float(np.median([x[1] for x in plain])):.3f}",
        plain_steps=len(plain), steps_per_s=f"{1e3 / median_ms:.2f}",
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

    exact = {
        "step": step == SCENE_STEPS,
        "params": same(state_after, params2),
        "adam": same(opt_after["state"], opt2["state"]),
        "palette": same(list(table_after[:4]), list(trainer2.table[:4])),
        "anneal": (trainer2.w_c, trainer2.b_f) == anneal_after,
        "generator": same(gen_after, trainer2.generator.get_state()),
    }
    fm.fused_mlp_backward.launches = 0
    rep = trainer2.fit(n_iters=SCENE_STEPS + SCENE_MORE, progress=False)
    torch.cuda.synchronize()
    more = fm.fused_mlp_backward.launches
    # where a step of the loop goes, on the device and on the host
    host = {}
    wall_ms, busy_ms, by_name = profile_window(
        lambda: trainer2.step_fn(trainer2.state, trainer2.bundle.pools, trainer2.table,
                                 trainer2.w_c, trainer2.generator), torch, host)
    say("profile", path="scene_step", wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", top_kernels_ms=json.dumps(top(by_name, 5)),
        host_cpu_ms=f"{sum(host.values()):.2f}", top_host_ops_ms=json.dumps(top(host, 10)),
        card=json.dumps(card))
    trainer2.close()
    say("scene_resume", exact=json.dumps(exact), more_steps=SCENE_MORE, bwd_launches=more,
        global_step=trainer2.global_step, last_total=f"{float(rep.total):.5f}")
    if not (all(exact.values()) and more == 2 * SCENE_MORE and math.isfinite(float(rep.total))
            and trainer2.global_step == SCENE_STEPS + SCENE_MORE):
        raise AssertionError(f"the resume failed: {exact}, {more} launches")
    return {"launches": launches, "median_ms": median_ms}


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

    # 2. the kernel builds, one nvcc per kernel, all started together
    t0 = time.perf_counter()
    names = ("fused_mlp_fwd", "fused_mlp_bwd", "fwd_probe")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build.build, names))
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
    # the network's multiply-adds per point, and the kernel's in its
    # padded packed layout (the difference is work the kernel wastes)
    macs = sum(m.weight.numel() for m in model_c.modules() if isinstance(m, torch.nn.Linear))
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
    in8_ragged = in8_coarse[: 100_003]  # not a multiple of the 64-point tile
    slices = {"sigma": (0, 1), "albedo": (1, 4), "shading": (4, 5), "residual": (5, 8),
              "semantic": (8, 8 + N_CLASSES), "pad": (8 + N_CLASSES, fm.OUT_W)}

    def plain(in8):  # in slices, to bound the plain version's memory
        return torch.cat([fm.fused_mlp_forward_plain(ops.packed, ops.pe, x)
                          for x in in8.split(1 << 21)])

    timing = {}
    max_err = 0.0
    for label, in8 in (("coarse_chunk", in8_coarse), ("fine_chunk", in8_fine),
                       ("ragged", in8_ragged)):
        got = fm.fused_mlp_forward(ops, in8)
        torch.cuda.synchronize()
        ref = plain(in8)
        errs = {}
        for sl, (a, b) in slices.items():
            d = (got[:, a:b].float() - ref[:, a:b].float()).abs().max().item()
            scale = max(ref[:, a:b].float().abs().max().item(), 1.0)
            errs[sl] = d / scale
            max_err = max(max_err, d)
        ok = all(e < KERNEL_TOL for e in errs.values()) and torch.isfinite(got.float()).all().item()
        n = in8.shape[0]
        flops, nbytes = fused_work(n, macs, padded_macs, ops.bbuf.numel())
        bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
        k_ms = cuda_ms(lambda: fm.fused_mlp_forward(ops, in8), 5, torch)
        p_ms = cuda_ms(lambda: plain(in8), 2, torch)
        timing[label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        say("kernel_vs_plain", shape=label, points=n,
            rel_err=json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}),
            tol=KERNEL_TOL, ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, achieved_tflops=f"{flops / k_ms / 1e9:.1f}", card=json.dumps(card))
        if not ok:
            raise AssertionError(f"fused kernel disagrees with its plain version at {label}: {errs}")
    del in8_fine

    # 4. the main path: one full view through render_views
    next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))  # warm-up
    torch.cuda.synchronize()
    fm.fused_mlp_forward.launches = fm.fused_mlp_backward.launches = 0
    t0 = time.perf_counter()
    view = next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))
    torch.cuda.synchronize()
    view_ms = 1e3 * (time.perf_counter() - t0)
    launches = fm.fused_mlp_forward.launches
    n_chunks = math.ceil(n_rays / chunk)
    want = 2 * n_chunks  # coarse + fine per chunk
    if (launches, fm.fused_mlp_backward.launches) != (want, 0):  # serving takes no gradient
        raise AssertionError(f"the view launched kernel 1 {launches} times (want {want}) and "
                             f"kernel 2 {fm.fused_mlp_backward.launches} times (want 0)")
    shapes = {"rgb": (H, W, 3), "disp": (H, W), "depth": (H, W), "acc": (H, W),
              "albedo": (H, W, 3), "shading": (H, W), "residual": (H, W, 3),
              "sem_label": (H, W), "sem_entropy": (H, W)}
    for k, shape in shapes.items():
        if view[k].shape != shape or not np.isfinite(view[k]).all():
            raise AssertionError(f"view map {k}: shape {view[k].shape} (want {shape}) or not finite")
    kernel_ms_view = n_chunks * (timing["coarse_chunk"]["ms"] + timing["fine_chunk"]["ms"])
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
        ms_per_view=f"{view_ms:.2f}", more_views_ms=json.dumps(more_ms),
        median_ms_per_view=f"{median_ms:.2f}", rays_per_s=f"{n_rays / median_ms * 1e3:.0f}",
        kernel_ms_per_view=f"{kernel_ms_view:.2f}", bound_ms_per_view=f"{view_bound_ms:.2f}",
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))

    # the view against the plain version on a seeded subset of its rays
    idx = torch.randperm(n_rays, generator=torch.Generator().manual_seed(3))[:SUBSET]
    sub = rays[0, idx.to(dev)]
    with torch.no_grad():
        kern = render_rays_chunked(model_c, model_f, mcfg, sub, rcfg, SUBSET).fine
        host_c = copy.deepcopy(model_c).to("cpu")
        host_f = copy.deepcopy(model_f).to("cpu")
        ref = render_rays_chunked(host_c, host_f, mcfg, sub.cpu(), rcfg, SUBSET).fine
    flat = idx.numpy()
    pairs = {
        "rgb": (view["rgb"].reshape(-1, 3)[flat], ref.rgb.numpy()),
        "depth": (view["depth"].reshape(-1)[flat], ref.depth.numpy()),
        "albedo": (view["albedo"].reshape(-1, 3)[flat], ref.albedo.numpy()),
        "sem_logits": (kern.sem_logits.float().cpu().numpy(), ref.sem_logits.numpy()),
    }
    errs = {}
    for k, (a, b) in pairs.items():
        errs[k] = float(np.mean(np.abs(a - b)) / max(np.abs(b).max(), 1.0))
    say("view_vs_plain", rays=SUBSET, mean_rel_err=json.dumps(errs), tol=VIEW_TOL)
    if not all(e <= VIEW_TOL for e in errs.values()):
        raise AssertionError(f"rendered view disagrees with the plain version: {errs}")

    # where a view's device time goes: one more view under the profiler
    wall_ms, busy_ms, by_name = profile_window(
        lambda: next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev)),
        torch)
    say("profile", path="view", wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}", top_kernels_ms=json.dumps(top(by_name)),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))
    del model_c, model_f
    torch.cuda.empty_cache()

    train = train_phases(torch, np, fc, mcfg, dev, card, macs, rays)
    probe = probe_phases(torch, np, dev, card)
    scene = scene_phases(torch, np, dev, card)

    t = timing["coarse_chunk"]
    b = train["bwd_timing"]["fine_step"]
    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fused_mlp_fwd.cu",
        "replaces": "intrinsicnerf_tpu/ops/fused_mlp.py:346",
        "launches": scene["launches"]["fwd"],  # the scene run: steps, renders, probes
        "launches_train_step_phase": train["launches"]["fwd"],
        "launches_per_step": train["launches"]["fwd"] // TIMED_STEPS,
        "launches_per_view": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],  # one coarse chunk of the view (2,097,152 points)
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this MLP
        "ms_per_step_call": train["fwd_step_ms"],
    }, {
        "name": "fused_mlp_bwd",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fused_mlp_bwd.cu",
        "replaces": "intrinsicnerf_tpu/ops/fused_mlp.py:354",
        "launches": scene["launches"]["bwd"],  # the scene run: 2 per step
        "launches_train_step_phase": train["launches"]["bwd"],
        "launches_per_step": train["launches"]["bwd"] // TIMED_STEPS,
        "max_abs_err": train["bwd_max_err"],
        "ms": b["ms"],  # the step's fine call (196,608 points)
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this MLP's gradient
        "per_shape": train["bwd_timing"],
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
