"""Weak scaling of the data-parallel training step.

Twin of ``bench_scaling.py`` (with its ``_spawn_rig``): the step of
``tools/bench.py`` (the same full production step, so the two numbers
compare: the Replica scene's 8x256 fused MLPs, 64 + 128 samples, the full
loss stack against a live cluster table, Adam) at a fixed 512 pairs per
rank through ``parallel/sharded_step.py:make_sharded_train_step``, eight
steps a CUDA graph replay, on 1, 2, 4 ... ranks.  Each world size is one
rig: one process per card, spawned on this host and joined with the
port's rendezvous (``parallel/distributed.py``, ``tcp://127.0.0.1``).
Even one rank joins a process group (NCCL), so its step runs the same
collectives as more ranks do.

Each row gives the world size, steps/s, global rays/s, the efficiency
against the smallest world (ms per step at it over ms per step here:
weak scaling keeps the time a step), the collective calls per replay,
and the NCCL kernels' device ms per step in a profiled window of
replays.  Asking for more ranks than the host has cards raises
``SystemExit`` naming the count.

``--device cpu`` runs the gloo rig at the JAX tool's CPU config (depth 4,
width 64, skip 2, 16 + 32 samples, 64 pixels a rank, 32x32, 8 classes,
one step a call); its processes share this host's cores, so its
efficiency measures their contention, not scaling, and it has no NCCL.

    python -m intrinsicnerf_tpu_torch.tools.bench_scaling               # every card, powers of 2
    python -m intrinsicnerf_tpu_torch.tools.bench_scaling --ranks 1 2 4
    python -m intrinsicnerf_tpu_torch.tools.bench_scaling --device cpu --ranks 1 2 --iters 10
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from intrinsicnerf_tpu_torch.tools.synthetic_replica import REPO, repo_env

RIG_TIMEOUT_S = 900.0


def available_ranks(device: str) -> int:
    """Ranks this host can run: one per card, or one per core on the CPU."""
    import torch

    return torch.cuda.device_count() if device.startswith("cuda") else os.cpu_count() or 1


def workload_config(device: str, n_rays: Optional[int]):
    """(mcfg, rcfg, tcfg, h, w, steps per call) of the step on ``device``."""
    import dataclasses

    import torch

    from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
    from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
    from intrinsicnerf_tpu_torch.tools import bench
    from intrinsicnerf_tpu_torch.train.step import TrainConfig

    if device.startswith("cuda"):
        tcfg = dataclasses.replace(bench.TRAIN, n_rays=n_rays or bench.TRAIN.n_rays)
        return bench.MLP, bench.RENDER, tcfg, bench.H, bench.W, 8
    mcfg = MLPConfig(depth=4, width=64, skips=(2,), pos_scalar_factor=10.0, enable_semantic=True,
                     num_semantic_classes=8, compute_dtype=torch.float32, use_fused_kernel=False)
    rcfg = RenderConfig(n_coarse=16, n_importance=32, perturb=1.0, raw_noise_std=1.0)
    return mcfg, rcfg, TrainConfig(n_rays=n_rays or 64), 32, 32, 1


def nccl_ms_per_step(step, args, n_calls: int, k: int) -> float:
    """Device ms per step of the NCCL kernels (by name) in ``n_calls``
    profiled calls of ``step``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            step(*args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    ms = sum(e.self_device_time_total / 1e3 for e in events
             if e.device_type == DeviceType.CUDA and e.key not in host
             and "nccl" in e.key.lower())
    return ms / (n_calls * k)


def run_rank(world: int, rank: int, coordinator: str, device: str, n_rays: Optional[int],
             iters: int, seed: int, out: str) -> None:
    """One rank of a rig: join the group, time the step, and (rank 0)
    write the row to ``out``."""
    import torch
    import torch.distributed as dist

    from intrinsicnerf_tpu_torch.parallel import mesh
    from intrinsicnerf_tpu_torch.parallel.distributed import initialize_distributed
    from intrinsicnerf_tpu_torch.tools import bench
    from intrinsicnerf_tpu_torch.train.step import make_multi_step

    if not device.startswith("cuda"):  # the host's threads (OMP_NUM_THREADS) split by rank
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(coordinator, world, rank, device=device)
    try:
        group = mesh.make_group(device)
        mcfg, rcfg, tcfg, h, w, k = workload_config(device, n_rays)
        step_fn, state, pools, table, w_c, gen = bench.make_workload(
            group.device, seed, mcfg, rcfg, tcfg, h, w, group=group)
        counters = {"reduce_grads": mesh.reduce_grads, "reduce_terms": mesh.reduce_terms}
        for c in counters.values():
            c.launches = c.captured = 0
        step = step_fn if k == 1 else make_multi_step(step_fn, k)
        warmup, windows = 5, 5
        # timed by calls of k steps (kept for the profiled window below)
        result = bench.measure(step, state, pools, table, w_c, gen,
                               rays_per_step=2 * tcfg.n_rays * world * k, steps_per_call=1,
                               windows=windows, steps_per_window=iters // k, warmup=warmup)
        calls = warmup + windows * (iters // k)
        per_call = ({n: c.captured for n, c in counters.items()} if k > 1 else
                    {n: c.launches / calls for n, c in counters.items()})
        nccl_ms = (nccl_ms_per_step(step, (state, pools, table, w_c, gen), 3, k)
                   if group.backend == "nccl" else None)
        ms = result["ms_per_step"] / k  # measure counted calls as steps
        row = {"world": world, "backend": group.backend, "steps_per_call": k,
               "pairs_per_rank": tcfg.n_rays, "ms_per_step": ms, "steps_per_s": 1e3 / ms,
               "global_rays_per_s": result["value"], "spread": result["spread"],
               "collective_calls_per_replay": per_call, "nccl_device_ms_per_step": nccl_ms,
               "last_total": result["last_total"]}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(row, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_rig(world: int, device: str, n_rays: Optional[int], iters: int, seed: int,
              timeout: float = RIG_TIMEOUT_S) -> dict:
    """Run ``world`` rank processes on this host and return rank 0's row;
    a failed rank, or a rig past ``timeout`` seconds, kills every rank."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "row.json")
        base = [sys.executable, "-m", "intrinsicnerf_tpu_torch.tools.bench_scaling",
                "--device", device, "--iters", str(iters), "--seed", str(seed),
                "--coordinator", f"tcp://127.0.0.1:{free_port()}", "--num_processes", str(world),
                "--out_row", out] + (["--n-rays", str(n_rays)] if n_rays else [])
        procs = [subprocess.Popen(base + ["--process_id", str(r)], cwd=REPO, env=repo_env(),
                                  start_new_session=True) for r in range(world)]
        t0 = time.time()
        try:  # until every rank ends, one fails, or the time is up
            while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
                if time.time() - t0 > timeout:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise SystemExit(f"the {world}-rank rig failed (exit codes {codes}; "
                             f"{time.time() - t0:.0f} s of at most {timeout:.0f})")
        with open(out) as f:
            return json.load(f)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=None,
                    help="world sizes to run (default: powers of 2 up to the cards)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-rays", type=int, default=None,
                    help="sampled pixels per rank (default 512 on the card, 64 on the CPU)")
    ap.add_argument("--iters", type=int, default=None,
                    help="steps per timed window (default 200 on the card, 10 on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    # one rank of a rig (what spawn_rig starts)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--out_row", default=None)
    args = ap.parse_args(argv)
    on_card = args.device.startswith("cuda")
    iters = args.iters or (200 if on_card else 10)
    if args.process_id is not None:
        run_rank(args.num_processes, args.process_id, args.coordinator, args.device, args.n_rays,
                 iters, args.seed, args.out_row)
        return {}
    have = available_ranks(args.device)
    ranks = args.ranks or [1 << i for i in range(8) if (1 << i) <= have]
    if max(ranks) > have:
        where = "card(s)" if on_card else "CPU core(s)"
        raise SystemExit(f"asked for {max(ranks)} ranks; this host has {have} {where}")
    if on_card:
        from intrinsicnerf_tpu_torch.ops import build

        for name in ("fused_mlp_fwd", "fused_mlp_bwd"):  # once, before the ranks start
            build.build(name)
    from intrinsicnerf_tpu_torch.tools.bench import device_info

    rows = {w: spawn_rig(w, args.device, args.n_rays, iters, args.seed) for w in ranks}
    base = min(rows)
    for r in rows.values():
        r["weak_scaling_efficiency"] = rows[base]["ms_per_step"] / r["ms_per_step"]
    result = {"device": device_info(args.device), "backend": rows[base]["backend"],
              "efficiency_baseline_ranks": base, "results": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
