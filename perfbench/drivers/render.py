"""Rendering traffic: ``render_views`` over the test split in a closed loop.

Set-up makes the test views' rays and both levels' weights from the seed
on the device (``scenes.make_weights``), loads the weights into the
port's models (the layout training leaves them in, eval mode) and
renders two views, which take every chunk shape the window uses.  The window consumes
``render_views`` view by view, one call per pass over the test split,
as an evaluation does, until ``--seconds`` have passed.  A view is one
request; its time is the gap between the host receiving it and the host
receiving the view before it (the first from the window's start).
``view_ms`` is the window over the views completed in it, ``view_ms.p90``
the 90th percentile of their times.  With ``--trace 1`` a sub-window of
about ``trace_s`` of views is profiled after it.  Then ``check_views``
completed views drawn from the seed, the slowest among them, are
rendered by the reference and compared map by map.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from perfbench import scenes, system, trace
from perfbench.reference import compare, nerf
from perfbench.reference import config as rconf


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(bench) -> dict:
    dev, config, traffic = bench.device, bench.config, bench.traffic
    arch, ds = rconf.arch(config), config["dataset"]
    cfg = system.framework_config(config, bench.workdir)
    mcfg = system.mlp_config(cfg, arch["classes"])
    h, w = ds["height"], ds["width"]

    rays = scenes.view_rays(ds, scenes.generator(bench.seed, 4, dev), ds["test_views"], dev)
    weights = scenes.make_weights(arch, scenes.generator(bench.seed, 2, dev), dev)
    models = system.serving_models(mcfg, weights, dev)

    def views(first: int):
        return system.render_views(models, mcfg, cfg.render, rays[first:], h, w, cfg.chunk, dev)

    t0 = time.perf_counter()
    for _ in views(rays.shape[0] - 2):
        pass
    _sync(dev)
    view_s = (time.perf_counter() - t0) / 2

    done, gaps = [], []
    t_window = time.perf_counter()
    last = t_window
    while last - t_window < bench.seconds:
        it = views(0)
        for i, view in enumerate(it):
            now = time.perf_counter()
            gaps.append(now - last)
            done.append((i, view))
            last = now
            if last - t_window >= bench.seconds:
                it.close()
                break
    _sync(dev)
    window_s = last - t_window

    summary = None
    if bench.trace:
        out = {}
        n = max(2, round(traffic["trace_s"] / view_s))
        with trace.profiled(bench.workdir, out):
            for _ in views(rays.shape[0] - n):
                pass
            out["units"] = n
        summary = out["summary"]

    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    del models
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng(bench.seed)
    n_check = min(traffic["check_views"], len(done))
    picks = {int(np.argmax(gaps))} | set(rng.choice(len(done), n_check, replace=False).tolist())
    pairs = []
    for j in sorted(picks):
        i, view = done[j]
        ref = nerf.render_view(weights["coarse"], weights.get("fine"), arch, rays[i])
        pairs.append((view, ref))
    record = types.SimpleNamespace(arch=arch, kind="render", window_s=window_s, views=len(done),
                                   rays_per_view=h * w, summary=summary)
    return {"t_window": t_window, "attempted": len(done), "failed": 0,
            "e2e": {"view_ms": 1e3 * window_s / len(done),
                    "view_ms.p90": 1e3 * float(np.percentile(gaps, 90))},
            "checks": compare.render_numbers(pairs), "memory_peak_bytes": peak,
            "record": record}
