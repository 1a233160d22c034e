"""Attribution probe for the fused forward kernel, on the card.

Times kernel 3 (``ops/csrc/fwd_probe.cu``), the stripped-down variants of
kernel 1's structure, over the sweep of ``tools_fwd_probe.py``: the five
variants at 8 layers, the tile, the layer count and an fp32 output.  One
line per case: layers, variant, tile (points per block), ms, TFLOP/s,
the bound and the card.  On the TPU the tile was the points of one VMEM
grid step (512..16,384); here it is the points per block: 64 (kernel 1's
tile, the warpgroups splitting the columns) or 128 (each warpgroup on its
own 64 rows).

    python -m intrinsicnerf_tpu_torch.tools.fwd_probe            # on the GPU
    python -m intrinsicnerf_tpu_torch.tools.fwd_probe --device cpu --n 4096

On the CPU it runs the plain version and reports host milliseconds,
which say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.ops import fwd_probe as fp

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s

# (layers, variant, tile, output type): the sweep of tools_fwd_probe.main,
# with the card's tiles in place of the TPU's
SWEEP = (
    [(8, v, 64, torch.bfloat16) for v in fp.VARIANTS]
    + [(8, "full", t, torch.bfloat16) for t in fp.TILES if t != 64]
    + [(n, "full", 64, torch.bfloat16) for n in (1, 2, 4, 16)]
    + [(8, "full", 64, torch.float32)]
)


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.splitlines()[0] if out else "nvidia-smi: no answer"


def time_ms(fn, dev: torch.device, iters: int, warmup: int = 4) -> float:
    """Mean ms per call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def bound(n: int, n_layers: int, out_dtype):
    """(bound ms, what bounds it) of one call at the H100's peaks."""
    flops, nbytes = fp.probe_work(n, n_layers, out_dtype)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def run_case(n_layers, variant, tile, out_dtype, n, dev, iters):
    """One case of the sweep: a dict with its timing and bound."""
    in8, ops = fp.probe_inputs(n_layers, n=n, device=dev)
    ms = time_ms(lambda: fp.fwd_probe(in8, ops, variant, tile, out_dtype), dev, iters)
    flops, _ = fp.probe_work(n, n_layers, out_dtype)
    bound_ms, bound_by = bound(n, n_layers, out_dtype)
    return {"layers": n_layers, "variant": variant, "tile": tile,
            "out": "f32" if out_dtype == torch.float32 else "bf16", "points": n,
            "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": bound_ms, "bound_by": bound_by}


def layer_slope(ms_by_layers) -> float:
    """Least-squares slope of ms over the layer count: the cost of one
    more 256x256 layer (``{layers: ms}``)."""
    xs, ys = list(ms_by_layers), list(ms_by_layers.values())
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def instantiations(usage) -> dict:
    """{"variant/tile": {registers, spill_stores, spill_loads}} of kernel
    3's instantiations in ``build.ptxas_usage`` of its build log."""
    out = {}
    for entry, u in usage.items():
        m = re.search(r"fwd_probe_kernelILi(\d)ELi(\d+)E", entry)
        if m:
            out[f"{fp.VARIANTS[int(m.group(1))]}/{m.group(2)}"] = u
    return out


def cublas_layer_ms(n: int, dev, iters: int) -> float:
    """One bf16 ``torch.matmul`` of ``[n, 256] x [256, 256]``: the library's
    rate for one trunk layer, a yardstick only (the port never calls it)."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, fp.W, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(fp.W, fp.W, device=dev, generator=g).to(torch.bfloat16)
    return time_ms(lambda: torch.matmul(a, b), dev, iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=fp.N_PTS, help="points per call")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = card_name() if on_card else "cpu (plain version, host ms)"
    print(f"# {card}; {torch.cuda.get_device_name(dev) if on_card else 'cpu'}; n={args.n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    for n_layers, variant, tile, out_dtype in SWEEP:
        r = run_case(n_layers, variant, tile, out_dtype, args.n, dev, args.iters)
        print(f"layers={r['layers']:2d} variant={r['variant']:7s} tile={r['tile']:4d} "
              f"out={r['out']:4s}: {r['ms']:8.4f} ms ({r['tflops']:6.1f} TF/s) "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) card={json.dumps(card)}",
              flush=True)
    if on_card:
        ms = cublas_layer_ms(args.n, dev, args.iters)
        print(f"yardstick: torch.matmul bf16 [{args.n}, 256] x [256, 256]: {ms:.4f} ms "
              f"({2.0 * args.n * fp.W * fp.W / ms / 1e9:.1f} TF/s) card={json.dumps(card)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
