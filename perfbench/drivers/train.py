"""Training traffic: the configuration's ``Trainer.fit`` in a closed loop.

Set-up makes the training set and both levels' weights from the seed on
the device (``scenes.make_weights``), builds the port's ``Trainer`` on them at the configuration's
``steps_per_call`` and cadences, installs a populated cluster table
through one ``rebuild_clusters`` over ``rebuild_views`` seeded views (so
the cluster term runs in every step, as it does after the first
rebuild), seeds the training draws, and drives the first steps through
the window's own call (``fit`` over whole blocks of ``steps_per_call``
steps) until at least ``first_steps`` have run: their loss, the first
block's gradients and the parameters after them are kept for the check.
It warms up for ``warmup_s`` more, sizing a block to about ``block_s``.

The window calls ``fit`` block after block until ``--seconds`` have
passed; every step is a training step and the periodic work falls where
the cadences put it (none of the 10k cadences comes this early).
``train_rays_per_s`` counts both rays of every pair over the whole
window.  ``step_hook`` records the host's enqueue time of each call.
With ``--trace 1`` one more block, one ``fit`` call as in the window,
is profiled after it.  Where the sampler has a warm-up (the object's
centre crop), the trainer's sampler then draws once at the first step
past it, and the reference draws with the same generator.

Then the reference makes its own cluster table: it renders the same
rebuild views with the same weights and clusters their albedo
(``reference.cluster``); the program's table is compared with it, and
the reference follows the first steps from the same weights and draws
with it.  The gaps are the check's numbers.
"""

from __future__ import annotations

import time
import types

import torch

from perfbench import scenes, system, trace
from perfbench.reference import cluster, compare
from perfbench.reference import config as rconf
from perfbench.reference import train as rtrain


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def prepare(bench) -> types.SimpleNamespace:
    """Set-up up to the first step: the inputs, the trainer holding the
    seeded weights and a rebuilt cluster table, its draws seeded."""
    dev, config, traffic = bench.device, bench.config, bench.traffic
    arch, hp, ds = rconf.arch(config), rconf.hyper(config), config["dataset"]
    cfg = system.framework_config(config, bench.workdir)

    data = scenes.train_data(ds, scenes.generator(bench.seed, 1, dev), dev)
    weights = scenes.make_weights(arch, scenes.generator(bench.seed, 2, dev), dev)
    gen = scenes.generator(bench.seed, 3, dev)
    n_rebuild = traffic["rebuild_views"]
    if ds["kind"] == "scene":
        pick = torch.randperm(ds["train_views"], generator=gen, device=dev)[:n_rebuild]
        cluster_rays = data["rays"][pick]
    else:
        cluster_rays = scenes.view_rays(ds, gen, n_rebuild, dev)
    bundle = system.scene_bundle(config, data, cluster_rays)
    trainer, sample_fn = system.trainer(cfg, config, bundle, bench.seed, dev)
    system.load_weights(trainer.state, weights)
    table, w_c, b_f = None, 0.0, 0.0
    if not hp["no_cluster"]:
        trainer.rebuild_clusters(hp["vis_every"], save=False)
        table = system.table_copy(trainer.table)
        w_c, b_f = rconf.cluster_anneal(hp, hp["vis_every"])
    draw_seed = (bench.seed * 7919 + 17) % (1 << 62)
    trainer.generator.manual_seed(draw_seed)
    k = cfg.train.steps_per_call
    return types.SimpleNamespace(arch=arch, hp=hp, k=k, data=data, weights=weights,
                                 trainer=trainer, sample_fn=sample_fn, pools=bundle.pools,
                                 cluster_rays=cluster_rays, table=table, w_c=w_c, b_f=b_f,
                                 draw_seed=draw_seed,
                                 observe=tuple(range(k, traffic["first_steps"] + k, k)))


def reference_table(p, precision: str = "float32"):
    """(the reference's cluster table, and the albedo and classes of its
    rebuild's pixels) of run ``p``; no table where the configuration
    runs without the cluster term."""
    if p.hp["no_cluster"]:
        return None, None, None
    h, w = p.hp["h"], p.hp["w"]
    albedo, label = cluster.rebuild_pixels(p.weights, p.arch, p.cluster_rays, h, w, precision)
    return cluster.rebuild(albedo, label, max(1, p.arch["classes"]), p.b_f), albedo, label


def sampler_draws(p, device):
    """The trainer's sampler's draw and the reference's at the first step
    past the warm-up: (colours, masks) each; None without a warm-up."""
    hp = p.hp
    if p.sample_fn is None or hp.get("precrop_iters", 0) <= 0:
        return None
    seed = p.draw_seed + 1
    batch = p.sample_fn(torch.Generator(device=device).manual_seed(seed), p.pools,
                        hp["precrop_iters"])
    gen = torch.Generator(device=device).manual_seed(seed)
    picks = rtrain.draw_pixels(gen, hp, p.data["rgb"].shape[0], hp["precrop_iters"], device)
    ref = rtrain.batch(p.data, hp, *picks)
    return (batch.rgb.float(), batch.semantic.float()), (ref["rgb"], ref["label"].float())


def run(bench) -> dict:
    dev, traffic = bench.device, bench.traffic
    p = prepare(bench)
    arch, hp, k, trainer, weights = p.arch, p.hp, p.k, p.trainer, p.weights

    losses, grads = {}, None
    while trainer.global_step < traffic["first_steps"]:
        report = trainer.fit(trainer.global_step + k, progress=False)
        losses[trainer.global_step] = float(report.total)
        if grads is None:
            grads = system.grad_leaves(trainer.state)
    n_first = trainer.global_step
    after = system.state_leaves(trainer.state)

    t0, calls = time.perf_counter(), 0
    while time.perf_counter() - t0 < traffic["warmup_s"]:
        trainer.fit(trainer.global_step + k, progress=False)
        _sync(dev)
        calls += 1
    t_call = (time.perf_counter() - t0) / calls
    block = k * max(1, round(traffic["block_s"] / t_call))

    enqueue = []
    trainer.step_hook = lambda done, t_s, t_e, work: enqueue.append(t_e - t_s)
    _sync(dev)
    t_window = time.perf_counter()
    start = trainer.global_step
    while time.perf_counter() - t_window < bench.seconds:
        report = trainer.fit(trainer.global_step + block, progress=False)
    _sync(dev)
    window_s = time.perf_counter() - t_window
    steps = trainer.global_step - start
    trainer.step_hook = None
    finite = bool(torch.isfinite(report.total))

    summary = None
    if bench.trace:
        out = {}
        with trace.profiled(bench.workdir, out):
            s0 = trainer.global_step
            trainer.fit(trainer.global_step + block, progress=False)
            out["units"] = trainer.global_step - s0
        summary = out["summary"]
    draws = sampler_draws(p, dev)

    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    trainer.close()
    del trainer
    p.trainer = None
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    ref_table, albedo, label = reference_table(p)
    ref_losses, ref_grads, ref_params = rtrain.follow(
        weights, p.data, p.draw_seed, n_first, arch, hp, ref_table, p.w_c, observe=tuple(losses))
    checks = compare.train_numbers(losses, ref_losses, grads, ref_grads,
                                   compare.delta(after, weights),
                                   compare.delta(ref_params, weights))
    if ref_table is not None:
        checks["table"] = compare.table_gap(p.table, ref_table, albedo, label)
    if draws is not None:
        checks["sampler"] = compare.sampler_gap(*draws)
    rays = 2 * hp["n_rays"]
    record = types.SimpleNamespace(
        arch=arch, hp=hp, kind="train", window_s=window_s, steps=steps, rays_per_step=rays,
        enqueue_s=sum(enqueue), summary=summary)
    return {"t_window": t_window, "attempted": steps, "failed": 0 if finite else steps,
            "e2e": {"train_rays_per_s": steps * rays / window_s},
            "checks": checks, "memory_peak_bytes": peak, "record": record}
