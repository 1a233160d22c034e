"""The benchmark's configurations at a size the host runs in seconds:
the published structure (depth 8, skip 4, both levels, every loss and
map), width 32, 8 + 8 samples, 8 pairs, 6 views of 12 x 16, on the
host's plain layers at float32."""

import copy

from perfbench import run as harness


def tiny(name: str) -> dict:
    c = copy.deepcopy(harness.data_file("configs", name))
    ds = c["dataset"]
    ds.update(height=12, width=16, train_views=6, test_views=5)
    if c["format"] == "scene_yaml":
        ds["semantic_classes"] = 3
        c["published"]["model"].update(netwidth=32, chunk="64")
        c["published"]["render"].update(N_rays="8*1", N_samples=8, N_importance=8)
        c["published"]["use_fused_kernel"] = False
        c["added"]["compute_dtype"] = "float32"
    else:
        c["added"].update(netwidth=32, N_samples=8, N_importance=8, chunk=64,
                          compute_dtype="float32")
        c["published"].update(N_rand=8, use_fused_kernel=False)
    return c


# The object pipeline's training has no cell: its eager step runs at the
# host's pace, too unsteady between runs for a bound (PERF.md).  Its path
# through the train driver and the reference is still held to the limits
# read for it on the card.
UNCELLED = {"lego.train": {"loss": 0.00035, "grad": 0.0035, "change": 0.1, "table": 0.01,
                           "sampler": 0.0}}


def tiny_bench(workload: str, seed: int, trace: bool = False, seconds: float = 1.0):
    config, traffic = workload.split(".")
    cell = workload
    if workload in UNCELLED:  # run as a cell of the same traffic
        cell = next(w["name"] for w in harness.manifest()["workloads"] if w["traffic"] == traffic)
    b = harness.Bench(cell, seed, seconds, trace, "cpu", config=tiny(config))
    if workload in UNCELLED:
        b.workload, b.limits = workload, dict(UNCELLED[workload])
    b.traffic = dict(b.traffic, warmup_s=0.3, block_s=0.2, trace_s=0.2)
    return b
