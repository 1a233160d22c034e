"""The readings that the limits of ``correct`` are set between, for the
training cell in NDC (``fern.train_ndc``, ``drivers/train_ndc.py``).

    python3 -m perfbench.control_ndc --seeds N [...]

On the card, at the cell's own size.  For every seed it puts the NDC
reference (``reference/ndc.py``) in the program's place in lower
precisions (``float8``, the control; ``bfloat16``, the program's own
precision, for comparison), its cluster table rebuilt in the same
precision, and with the faults the cell can have planted: a step that
leaves the state unchanged; half of the batch left out; a cluster table
left empty; the rays projected with the focal of the full-size images
(8x at ``factor`` 8, ``focal_8x``); the projection left out
(``no_ndc``).  Each variant's numbers against the float32 reference are
printed as one JSON line, as ``perfbench.control`` prints them; the two
ray faults keep the float32 table.  The program's own readings, the
lower ones, come from ``python3 -m perfbench.control --workloads
fern.train_ndc --seeds ... --program 1 --control 0``.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

import torch

from perfbench import run as harness
from perfbench.reference import compare, ndc

CELL = "fern.train_ndc"
# name: (precision, fault of the step, focal as a multiple of the views'; None: no projection)
VARIANTS = {"float8": ("float8", None, 1.0), "bfloat16": ("bfloat16", None, 1.0),
            "half_batch": ("float32", "half_batch", 1.0),
            "unchanged": ("float32", "unchanged", 1.0),
            "focal_8x": ("float32", None, 8.0), "no_ndc": ("float32", None, None)}


def readings(bench) -> dict:
    driver = harness.code_file("drivers", "train_ndc", bench.root)
    train = driver.base(bench)
    p = driver.prepare(bench)
    p.trainer.close()
    p.trainer = None
    n, dev = p.observe[-1], bench.device
    base_t, albedo, label = train.reference_table(p)

    def follow(precision, fault, table, focal):
        return ndc.follow(p.weights, p.data, p.draw_seed, n, p.arch, p.hp, focal, table, p.w_c,
                          observe=p.observe, precision=precision, fault=fault)

    def rays(focal):
        b = ndc.draw_batch(torch.Generator(device=dev).manual_seed(p.draw_seed + 1), p.data,
                           p.hp, focal, 0)
        return b["rays"], b["rgb"], b["label"]

    base_l, base_g, base_p = follow("float32", None, base_t, p.focal)
    base_rays = rays(p.focal)
    out = {}
    for name, (precision, fault, scale) in VARIANTS.items():
        focal = None if scale is None else scale * p.focal
        table = base_t if precision == "float32" else train.reference_table(p, precision)[0]
        v_l, v_g, v_p = follow(precision, fault, table, focal)
        out[name] = compare.train_numbers(v_l, base_l, v_g, base_g,
                                          compare.delta(v_p, p.weights),
                                          compare.delta(base_p, p.weights))
        out[name]["table"] = compare.table_gap(table, base_t, albedo, label)
        out[name]["rays"] = ndc.ray_gap(rays(focal), base_rays)
    empty = dict(base_t, has_cluster=torch.zeros_like(base_t["has_cluster"]))
    out["empty_table"] = {"table": compare.table_gap(empty, base_t, albedo, label)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control_ndc: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.keep_jax_out()
    for seed in args.seeds:
        bench = harness.Bench(CELL, seed, 0.0, False, "cuda")
        try:
            for name, numbers in readings(bench).items():
                print(json.dumps({"workload": CELL, "seed": seed, "variant": name,
                                  "numbers": numbers}), flush=True)
        finally:
            shutil.rmtree(bench.workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
