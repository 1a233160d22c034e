"""Kernels 1 and 2 alone, then the whole graphed step, each beside its bound.

Twin of ``tools_kernel_bench.py``: at the bench config's coarse (65,536)
and fine (196,608) point counts of one training step, the time of

- kernel 1 alone (``fused_mlp_forward`` on the model's operands, its
  weight image built once);
- the forward and backward of the packed training state
  (``fused_mlp_apply`` on ``PackedMLP``'s buffers, then ``backward``):
  kernel 1's weight image, kernel 1, and kernel 2;

and the graphed training step of ``tools/bench.py`` (8 steps a replay).
Each time stands beside the least time the card could take for the same
work, the larger of its operations at the bf16 peak and its bytes at the
memory's rate (counted as ``chip_smoke.py:fused_work`` counts them: the
network's own multiply-adds; each point's 8 fp32 in and 128 bf16 out,
the weights and biases read once; the backward's multiply-adds from
``tools/bwd_passes.py:backward_macs``, with its cotangent in and fp32
gradients out).  Times come from CUDA events after a warm-up; one JSON
line per entry, with the card's name and power limit.

    python -m intrinsicnerf_tpu_torch.tools.kernel_bench [--iters 50]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from intrinsicnerf_tpu_torch.tools.bwd_passes import PEAK_BF16_FLOPS, PEAK_BYTES, backward_macs

SIZES = (("coarse", 65_536), ("fine", 196_608))
STEPS_PER_CALL = 8  # the graphed step's, as tools/bench.py's default


def fused_work(n_points: int, macs_per_point: int, n_weights: int, n_bias: int):
    """(FLOP, bytes) of one fused-MLP forward over ``n_points``: the
    network's own multiply-adds per point; each point reads 8 fp32 and
    writes 128 bf16; the bf16 weights and fp32 biases are read once."""
    flops = 2.0 * macs_per_point * n_points
    nbytes = n_points * (8 * 4 + 128 * 2) + n_weights * 2 + n_bias * 4
    return flops, nbytes


def backward_work(n_points: int, bwd_macs_per_point: int, n_weights: int, n_bias: int):
    """(FLOP, bytes) of kernel 2 over ``n_points``: its multiply-adds; the
    points and the bf16 cotangent in; the weights and biases in, their
    fp32 gradients out."""
    flops = 2.0 * bwd_macs_per_point * n_points
    nbytes = n_points * (8 * 4 + 128 * 2) + n_weights * (2 + 4) + n_bias * (4 + 4)
    return flops, nbytes


def bound(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the larger of the two floors."""
    by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES), by


def time_ms(fn: Callable[[], object], iters: int, device: torch.device, warmup: int = 3) -> float:
    """Mean ms per call of ``fn``: CUDA events on the card, the host's clock
    (which times the plain versions) on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def random_in8(n: int, seed: int, device) -> torch.Tensor:
    """``[n, 8]`` kernel inputs of seeded points in [-2, 2]^3 and unit directions."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-2, 2, (n, 1, 3)).astype(np.float32))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    return fm.build_in8(pts.to(device), dirs.to(device))


def kernel_rows(model, mcfg, sizes, iters: int, seed: int = 0) -> Dict[str, dict]:
    """``{label: {points, fwd_ms, fwd_bound_ms, ..., fwd_bwd_ms, ...}}`` of
    a ``PackedMLP`` at each ``(label, points)`` of ``sizes``."""
    from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

    dev = model.weight.device
    ops = model.fused_operands(mcfg)
    macs = sum(v.numel() for k, v in model.state_dict().items() if k.endswith(".weight"))
    bwd_macs = sum(backward_macs(model).values())
    n_w, n_b = model.weight.numel(), model.bias.numel()
    rows = {}
    for i, (label, n) in enumerate(sizes):
        in8 = random_in8(n, seed + i, dev)

        def fwd_bwd():
            model.weight.grad = model.bias.grad = None
            fm.fused_mlp_apply(model.flat(), mcfg, in8).sum().backward()

        f_flops, f_bytes = fused_work(n, macs, n_w, n_b)
        b_flops, b_bytes = backward_work(n, bwd_macs, n_w, n_b)
        f_bound, f_by = bound(f_flops, f_bytes)
        fb_bound, fb_by = bound(f_flops + b_flops, f_bytes + b_bytes)
        fwd_ms = time_ms(lambda: fm.fused_mlp_forward(ops, in8), iters, dev)
        fb_ms = time_ms(fwd_bwd, iters, dev)
        rows[label] = {"points": n, "fwd_ms": fwd_ms, "fwd_bound_ms": f_bound, "fwd_bound_by": f_by,
                       "fwd_tflops": f_flops / fwd_ms / 1e9, "fwd_bwd_ms": fb_ms,
                       "fwd_bwd_bound_ms": fb_bound, "fwd_bwd_bound_by": fb_by,
                       "fwd_bwd_tflops": (f_flops + b_flops) / fb_ms / 1e9}
    return rows


def step_row(workload, k: int, iters: int, step_bound_ms: float) -> dict:
    """ms per step of the bench's step at ``k`` steps a call (a CUDA graph
    replay on the card) beside ``step_bound_ms``."""
    from intrinsicnerf_tpu_torch.tools.bench import measure

    step_fn, state, pools, table, w_c, gen = workload
    r = measure(step_fn, state, pools, table, w_c, gen, rays_per_step=1, steps_per_call=k,
                windows=3, steps_per_window=iters, warmup=3)
    return {"steps_per_call": k, "ms_per_step": r["ms_per_step"], "bound_ms": step_bound_ms,
            "spread": r["spread"], "last_total": r["last_total"]}


def main(argv: Optional[list] = None) -> dict:
    from intrinsicnerf_tpu_torch import resolve_device
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP
    from intrinsicnerf_tpu_torch.tools import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = PackedMLP(bench.MLP, device=dev, generator=torch.Generator().manual_seed(0))
    rows = kernel_rows(model, bench.MLP, SIZES, args.iters)
    info = bench.device_info(dev)
    for label, row in rows.items():
        print(json.dumps({"entry": f"kernels_{label}", **row, "device": info}), flush=True)
    del model
    # one step: each level's fused MLP forward and backward at the two sizes
    step_bound = sum(r["fwd_bwd_bound_ms"] for r in rows.values())
    step = step_row(bench.make_workload(dev), STEPS_PER_CALL, 200, step_bound)
    print(json.dumps({"entry": "graphed_step", **step, "device": info}), flush=True)
    return {"kernels": rows, "step": step, "device": info}


if __name__ == "__main__":
    main()
