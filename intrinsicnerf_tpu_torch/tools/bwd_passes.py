"""Kernel 2's passes timed one by one on the card.

Kernel 2 (``ops/csrc/fused_mlp_bwd.cu``) is one call of three passes: the
activation pass (its weight image, then the backward chain over kernel
1's saved forward into the bf16 arena), the weight-gradient pass (dW =
A^T G over the saved forward's and the arena's points) and the
fixed-order reductions.  This tool profiles ``fused_mlp_backward`` at the
Replica training step's two shapes, on the saved forward of kernel 1's
saving instance, and reports each pass's device time beside its bound:

    python -m intrinsicnerf_tpu_torch.tools.bwd_passes [--iters 10]

The model is the Replica scene config (``configs/scene/replica_room_0.yaml``,
8x256, C = 27) with seeded weights; the points are the step's 1,024 rays
of one 320x240 view at 64 (coarse) and 192 (fine) stratified samples; the
cotangent is that of a seeded squared-error loss.  One JSON line per
shape, with the card's name and power limit.  It needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess

import torch

from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
ARENA_BYTES = 2 * fm.GRAD_COLS  # kernel 2's bf16 gradient arena per point: 5,888
# the saved forward per point, its bf16 activations and its share of a
# tile's 32-bit mask words: 6,272
SAVED_BYTES = 2 * fm.SAVED_COLS + 4 * fm.MASK_WORDS // fm.FWD_TILE
# each pass, by a substring of its kernels' names (the activation pass's
# weight image, bwd_act_wimg_kernel, counts with it)
PASSES = {"act": "bwd_act", "wgrad": "bwd_wgrad", "reduce": "reduce_rows"}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "scene", "replica_room_0.yaml")
N_CLASSES = 27


def backward_macs(model) -> dict:
    """Multiply-adds per point of the backward on the network's own layers
    (its reference state_dict's weights, in either layout): the weight
    product of every layer and the input product of every layer whose
    input depends on parameters (all but the PE-fed w0, w5x and wv_d).  It
    recomputes nothing: the forward's training launch saves what the
    backward reads.  A model without the semantic head (the object
    configurations) counts none of it."""
    cfg = model.cfg
    lin = {k[: -len(".weight")]: v for k, v in model.state_dict().items() if k.endswith(".weight")}
    macs = sum(w.numel() for w in lin.values())
    pe_macs = 2 * cfg.input_ch * cfg.width + cfg.input_ch_views * (cfg.width // 2)
    return {"weight_products": macs, "input_products": macs - pe_macs}


def pass_bounds(n: int, work: dict, splits: int) -> dict:
    """{pass: (bound ms, "operations" or "bytes")} for ``n`` points.

    Activation pass: the input products; it reads the cotangent (256 B)
    and the saved ReLU masks (384 B) and writes the arena.  Weight-gradient
    pass: the weight products; it reads the saved activations and the
    arena and writes ``splits`` fp32 partials of the 835,584 weights.  Reductions:
    they read the partials and the per-tile bias partials and write dW
    and db."""
    w_total, b_total = 835_584, 2_944
    tiles = -(-n // 64)
    jobs = {
        "act": (2.0 * n * work["input_products"], n * (256 + 384 + ARENA_BYTES)),
        "wgrad": (2.0 * n * work["weight_products"],
                  n * (SAVED_BYTES - 384 + ARENA_BYTES) + splits * w_total * 4),
        "reduce": (float(splits * w_total + tiles * b_total),
                   4 * (splits * w_total + tiles * b_total + w_total + b_total)),
    }
    out = {}
    for name, (flops, nbytes) in jobs.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def pass_times(fn, iters: int) -> dict:
    """{pass: device ms per call} of ``fn`` (one kernel-2 call) under
    torch.profiler, after a warm-up call, with every kernel's own time
    under ``"kernels"``.  Raises if a pass's kernels are not found."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
    out = {p: sum(v for k, v in by_name.items() if sub in k) for p, sub in PASSES.items()}
    missing = [p for p, v in out.items() if v <= 0.0]
    if missing:
        raise RuntimeError(f"kernel 2's passes {missing} not found among the profiled kernels "
                           f"{sorted(by_name)}")
    out["kernels"] = {k[:60]: v for k, v in by_name.items()}
    return out


def step_inputs(model, rcfg, n_rays: int, n_samples: int, device):
    """The training step's point block: the first ``n_rays`` rays of one
    320x240 view at ``n_samples`` stratified samples, packed as in8."""
    from intrinsicnerf_tpu_torch.core.rays import create_rays
    from intrinsicnerf_tpu_torch.core.sampling import stratified_z_vals

    h, w = 240, 320
    c2w = torch.eye(4, device=device)
    c2w[:3, 3] = torch.tensor([0.3, -0.2, -1.0])
    rays = create_rays(c2w, h, w, w / 2, w / 2, (w - 1) / 2, (h - 1) / 2, 0.1, 10.0)[0, :n_rays]
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], n_samples)
    return fm.build_in8(rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None], rays[:, 8:11])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_passes: needs a CUDA device")
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    fc = from_yaml(CONFIG)
    mcfg = dataclasses.replace(fc.mlp, num_semantic_classes=N_CLASSES)
    model = PackedMLP(mcfg, device=dev, generator=torch.Generator().manual_seed(5))
    ops = model.fused_operands(mcfg)
    work = backward_macs(model)
    gen = torch.Generator(device=dev).manual_seed(6)
    n_rays = 2 * fc.train.n_rays
    for label, samples in (("coarse_step", fc.render.n_coarse),
                           ("fine_step", fc.render.n_coarse + fc.render.n_importance)):
        in8 = step_inputs(model, fc.render, n_rays, samples, dev)
        out, saved = fm.fused_mlp_forward_saving(ops, in8)
        g = ((out.float() - torch.rand(out.shape, generator=gen, device=dev)) / out.shape[0])
        g[:, 8 + N_CLASSES:] = 0.0
        g = g.to(torch.bfloat16)
        n = in8.shape[0]
        t = pass_times(lambda: fm.fused_mlp_backward(ops, saved, g), args.iters)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fm.fused_mlp_backward(ops, saved, g)
        end.record()
        torch.cuda.synchronize()
        bounds = pass_bounds(n, work, fm.backward_splits(n))
        print(json.dumps({
            "shape": label, "points": n, "call_ms": start.elapsed_time(end) / args.iters,
            "pass_ms": {p: t[p] for p in PASSES}, "kernels_ms": t["kernels"],
            "bound_ms": {p: b[0] for p, b in bounds.items()},
            "bound_by": {p: b[1] for p, b in bounds.items()}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
