"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m perfbench.run --workload <config>.<traffic> --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The harness is driven by data: the cell names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``), the mix names its driver
(``perfbench/drivers/<driver>.py``), each per-layer metric has its reader
(``perfbench/metrics/<metric>.py``) and each cell its limits of
correctness (``perfbench/limits/<cell>.json``); ``BENCHMARK.json`` says
which metrics a cell reports.

A run sets up (its inputs and weights made from ``--seed`` on the
device, the program built and warmed up), measures for ``--seconds``,
optionally profiles a short sub-window after it (``--trace 1``), reads
the device's peak memory, frees the program's state and then checks
what the timed path produced against the plain reference.  The last
lines on standard error and the ``checks`` key, last in the result, give
each number compared beside its limit.  Without the card(s), or with
JAX loaded in the process once the window has closed, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "intrinsicnerf_tpu")


class Refused(RuntimeError):
    """A run that must print no result."""


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def data_file(kind: str, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "perfbench", kind, f"{name}.json")) as f:
        return json.load(f)


def code_file(kind: str, name: str, root: str = ROOT) -> types.ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, "perfbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise Refused(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    """Whether a cell reports ``metric``: every cell, or those its
    ``workloads`` lists."""
    return workload in metric.get("workloads", [workload])


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Bench:
    """One run's settings, inputs and scratch directory."""

    def __init__(self, workload, seed, seconds, trace, device, root=ROOT, config=None):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.root = device, root
        self.manifest = manifest(root)
        self.cell = cell(self.manifest, workload)
        self.config = (config if config is not None
                       else data_file("configs", self.cell["config"], root))
        self.traffic = data_file("traffic", self.cell["traffic"], root)
        self.limits = data_file("limits", workload, root)
        self.workdir = tempfile.mkdtemp(prefix="perfbench-")


def keep_jax_out() -> None:
    """TensorBoard, which the program's logger imports, loads TensorFlow
    where that is installed, and TensorFlow loads JAX: keep TensorFlow
    out of the process (TensorBoard then writes through its own stub)."""
    if "tensorflow" not in sys.modules:
        sys.modules["tensorflow"] = None


def run_cell(bench: Bench) -> dict:
    """The result of one run (before the check for JAX)."""
    keep_jax_out()
    import torch

    if bench.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver = code_file("drivers", bench.traffic["driver"], bench.root)
    try:
        out = driver.run(bench)
    finally:
        shutil.rmtree(bench.workdir, ignore_errors=True)
    out["e2e"]["setup_s"] = out["t_window"] - T0
    checks = {k: {"value": v, "limit": bench.limits[k]} for k, v in out["checks"].items()}
    correct = (out["failed"] == 0 and set(checks) == set(bench.limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    m = bench.manifest
    if bench.trace:
        metrics = {}
        for spec in m["per_layer"]:
            if applies(spec, bench.workload):
                value = code_file("metrics", spec["name"], bench.root).read(out["record"])
                if value is not None:
                    metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        metrics = {spec["name"]: {"value": out["e2e"][spec["name"]], "unit": spec["unit"]}
                   for spec in m["end_to_end"] if applies(spec, bench.workload)}
    if torch.cuda.is_available() and bench.device == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": bench.cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    summary = out["record"].summary
    if bench.trace and summary is not None:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        chips = cell(manifest(), args.workload)["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA card(s); torch sees "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        result = run_cell(Bench(args.workload, args.seed, args.seconds, bool(args.trace), "cuda"))
        found = loaded_forbidden()
        if found:
            raise Refused(f"modules of the JAX stack loaded in this process: {found}")
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
