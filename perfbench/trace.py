"""A short profiled sub-window and what the readers take from it.

``torch.profiler`` traces the host and the device over the sub-window;
its Chrome trace is read back for the device's busy intervals (kernels,
copies and fills), their union over the window, the device time of each
kernel by name, and the idle gaps between busy intervals, each named by
what the host was doing in it (the innermost host operation or
benchmark span covering the gap's middle).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"


class Summary:
    """What one traced sub-window holds.  ``units`` counts the work the
    window completed (steps or views)."""

    def __init__(self, window_s: float, busy_s: float, kernels: Dict[str, float],
                 gaps: List[Tuple[str, float]], units: int):
        self.window_s, self.busy_s, self.kernels, self.gaps, self.units = (
            window_s, busy_s, kernels, gaps, units)

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name contains one of ``names``."""
        return sum(s for k, s in self.kernels.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], s] for k, s in ops],
                "idle_gaps": sorted(self.gaps, key=lambda g: -g[1])[:10]}


@contextlib.contextmanager
def profiled(workdir: str, out: dict):
    """Profile the body; ``out["summary"]`` is set on exit (the body sets
    ``out["units"]``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    path = os.path.join(workdir, "trace.json")
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    out["summary"] = summarize(events, out.get("units", 0))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list, units: int) -> Summary:
    """The summary of a Chrome trace's events (times in microseconds)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no benchmark window")
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    dev, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s, t = max(s, w0), min(s + d, w1)
        if t <= s:
            continue
        dev.append((s, t))
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + (t - s) * 1e-6
    busy = _union(dev)
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    for s, t in sorted(holes, key=lambda h: h[0] - h[1])[:10]:
        mid = 0.5 * (s + t)
        cover = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = min(cover, key=lambda e: float(e["dur"]))["name"] if cover else "host: no traced op"
        gaps.append([name[:160], (t - s) * 1e-6])
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=sum(t - s for s, t in busy) * 1e-6,
                   kernels=kernels, gaps=gaps, units=units)
