#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version on the card, renders one
full 320x240 view of the Replica scene configuration
(``configs/scene/replica_room_0.yaml``: 8x256 trunk with the skip, five
heads, C = 27 semantic classes, 64 + 128 samples, 32,768-ray chunks)
from seeded random weights through ``render_views``, checks that the
view went through the kernels and agrees with the plain version on a
subset of its rays, and prints what it measured.  The last line is
``{"ok": true, "device": {...}}``; any failed phase exits non-zero and
prints no such line.  It needs one card and imports nothing of JAX.
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

    # 2. the kernel build
    _, secs, log = build.build("fused_mlp_fwd")
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", kernel="fused_mlp_fwd", seconds=f"{secs:.1f}", ptxas=json.dumps(" | ".join(regs)))

    # the configuration, as a user loads it
    fc = from_yaml(CONFIG)
    mcfg = dataclasses.replace(fc.mlp, num_semantic_classes=N_CLASSES)
    rcfg, chunk = fc.render, fc.chunk
    if not (mcfg.use_fused_kernel and (mcfg.depth, mcfg.width) == (8, 256)):
        raise AssertionError(f"{CONFIG} no longer selects the fused 8x256 model: {mcfg}")
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
    fm.fused_mlp_forward.launches = 0
    t0 = time.perf_counter()
    view = next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))
    torch.cuda.synchronize()
    view_ms = 1e3 * (time.perf_counter() - t0)
    launches = fm.fused_mlp_forward.launches
    n_chunks = math.ceil(n_rays / chunk)
    want = 2 * n_chunks  # coarse + fine per chunk
    if launches != want:
        raise AssertionError(f"main path launched the fused kernel {launches} times, want {want}")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        next(render_views(model_c, model_f, mcfg, rcfg, rays, H, W, chunk, device=dev))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern_ev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kern_ev) / 1e3
    top = {}
    for e in kern_ev:  # by name, cut short (template arguments make names long)
        top[e.key[:60]] = top.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])
    say("profile", wall_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.2f}",
        busy_share=f"{busy_ms / wall_ms:.3f}",
        top_kernels_ms=json.dumps({k: round(v, 3) for k, v in top.items()}),
        card=json.dumps(card), clocks=json.dumps(smi(CLOCKS)))

    t = timing["coarse_chunk"]
    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "intrinsicnerf_tpu_torch/ops/csrc/fused_mlp_fwd.cu",
        "replaces": "intrinsicnerf_tpu/ops/fused_mlp.py:346",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this MLP
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
