"""The readings that the limits of ``correct`` are set between.

    python3 -m perfbench.control --workloads <cell> [...] --seeds N [...] [--program 1]
        [--control 0]

On the card, at each cell's own size.  For every seed it puts the
reference in the program's place in lower precisions (``float8``, the
control; ``bfloat16``, the program's own precision, for comparison),
its cluster table rebuilt in the same precision, and with the faults a
cell can have planted (a training step that leaves the state
unchanged; half of the batch left out; a cluster table left empty; a
view's answer altered where it is produced: the colour channels
swapped, or the rays past the last ``TAIL`` of the view left out), and
prints each variant's numbers against the float32 reference as one
JSON line; a render cell's at several quantiles (``maps@q``).  With
``--program 1`` it also runs the program itself on each seed, a short
window in this process, and prints its numbers: the lower readings.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import collections
import json
import shutil
import sys

import numpy as np
import torch

from perfbench import run as harness
from perfbench import scenes
from perfbench.reference import compare, nerf
from perfbench.reference import config as rconf
from perfbench.reference import train as rtrain

TRAIN_VARIANTS = {"float8": ("float8", None), "bfloat16": ("bfloat16", None),
                  "half_batch": ("float32", "half_batch"), "unchanged": ("float32", "unchanged")}
RENDER_VARIANTS = ("float8", "bfloat16", "altered", "half_batch", "tail")
QUANTILES = (0.9, 0.99, 0.999, 0.9999, 1.0)
TAIL = 0.05


def train_readings(bench) -> dict:
    driver = harness.code_file("drivers", "train", bench.root)
    p = driver.prepare(bench)
    p.trainer.close()
    p.trainer = None
    n = p.observe[-1]
    base_t, albedo, label = driver.reference_table(p)

    def follow(precision, fault, table):
        return rtrain.follow(p.weights, p.data, p.draw_seed, n, p.arch, p.hp, table, p.w_c,
                             observe=p.observe, precision=precision, fault=fault)

    base_l, base_g, base_p = follow("float32", None, base_t)
    out = {}
    for name, (precision, fault) in TRAIN_VARIANTS.items():
        table = base_t if precision == "float32" else driver.reference_table(p, precision)[0]
        v_l, v_g, v_p = follow(precision, fault, table)
        out[name] = compare.train_numbers(v_l, base_l, v_g, base_g,
                                          compare.delta(v_p, p.weights),
                                          compare.delta(base_p, p.weights))
        if base_t is not None:
            out[name]["table"] = compare.table_gap(table, base_t, albedo, label)
    if base_t is not None:
        empty = dict(base_t, has_cluster=torch.zeros_like(base_t["has_cluster"]))
        out["empty_table"] = {"table": compare.table_gap(empty, base_t, albedo, label)}
    return out


def quantile_numbers(pairs) -> dict:
    errors = compare.render_errors(pairs)
    return {"maps": compare.worst_view(errors, compare.QUANTILE),
            **{f"maps@{q}": compare.worst_view(errors, q) for q in QUANTILES}}


def as_view(maps: dict) -> dict:
    """A reference render as ``render_views`` yields a view."""
    view = {k: maps[k].cpu().numpy() for k in compare.MAPS if k in maps}
    if "sem" in maps:
        view["sem_label"] = maps["sem"].argmax(-1).cpu().numpy()
    return view


def render_readings(bench) -> dict:
    dev, config, traffic = bench.device, bench.config, bench.traffic
    arch, ds = rconf.arch(config), config["dataset"]
    rays = scenes.view_rays(ds, scenes.generator(bench.seed, 4, dev), ds["test_views"], dev)
    weights = scenes.make_weights(arch, scenes.generator(bench.seed, 2, dev), dev)
    rng = np.random.default_rng(bench.seed)
    picks = rng.choice(ds["test_views"], traffic["check_views"] + 1, replace=False)
    pairs = {name: [] for name in RENDER_VARIANTS}
    for i in picks:
        ref = nerf.render_view(weights["coarse"], weights.get("fine"), arch, rays[i])
        for name in RENDER_VARIANTS:
            precision = name if name in nerf.PRECISIONS else "float32"
            maps = ref if precision == "float32" else nerf.render_view(
                weights["coarse"], weights.get("fine"), arch, rays[i], precision=precision)
            view = as_view(maps)
            if name == "altered":
                view = dict(view, rgb=view["rgb"][:, ::-1].copy())
            if name in ("half_batch", "tail"):
                keep = len(view["acc"]) // 2 if name == "half_batch" else round(
                    len(view["acc"]) * (1 - TAIL))
                view = {k: np.concatenate([v[:keep], np.zeros_like(v[keep:])])
                        for k, v in view.items()}
            pairs[name].append((view, ref))
    return {name: quantile_numbers(p) for name, p in pairs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--program", type=int, default=0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.keep_jax_out()
    for workload in args.workloads:
        for seed in args.seeds:
            if args.control:
                bench = harness.Bench(workload, seed, args.seconds, False, "cuda")
                kind = bench.traffic["driver"]
                try:
                    readings = (train_readings if kind == "train" else render_readings)(bench)
                finally:
                    shutil.rmtree(bench.workdir, ignore_errors=True)
                for name, numbers in readings.items():
                    print(json.dumps({"workload": workload, "seed": seed, "variant": name,
                                      "numbers": numbers}), flush=True)
            if args.program:
                bench = harness.Bench(workload, seed, args.seconds, False, "cuda")
                bench.limits = collections.defaultdict(lambda: float("inf"), bench.limits)
                compare.render_numbers = quantile_numbers
                result = harness.run_cell(bench)
                print(json.dumps({"workload": workload, "seed": seed, "variant": "program",
                                  "numbers": {k: c["value"] for k, c in
                                              result["checks"].items()},
                                  "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
