"""Training traffic on a forward-facing capture in NDC: the configuration's
``Trainer.fit`` in a closed loop, as ``drivers/train.py`` drives it.

Set-up builds the trainer as the object CLI (``train_object.build_trainer``)
builds it for an LLFF scene: the depth range [0, 1], the NDC focal of the
port's ``ndc_focal_for``, the pose sampler of ``make_object_sample_fn``
given that focal, and the rebuild's views (``rebuild_views`` seeded
forward-facing views) projected by ``prepare.apply_ndc_to_rays``; the
inputs and weights are made from the seed (``forward_facing``,
``scenes.make_weights``).  Then, as in ``drivers/train.py``: a populated
cluster table from one ``rebuild_clusters``, the draws seeded, the first
steps through the window's own call, a warm-up, the window, and with
``--trace 1`` one more profiled block.

The check: the reference (``reference/ndc.py``) projects the same world
rays of the rebuild's views itself, rebuilds its own table from them and
follows the first steps from the same weights and draws; ``loss``,
``grad``, ``change`` and ``table`` are ``drivers/train.py``'s numbers.
``rays``: the trainer's sampler draws once from a fixed seed and the
reference draws and projects with the same generator (``ndc.ray_gap``).
"""

from __future__ import annotations

import dataclasses
import time
import types

import torch

from perfbench import forward_facing, scenes, system, trace
from perfbench import run as harness
from perfbench.reference import compare, ndc
from perfbench.reference import config as rconf


def base(bench) -> types.ModuleType:
    """``drivers/train.py``, whose helpers this driver shares."""
    return harness.code_file("drivers", "train", bench.root)


def prepare(bench) -> types.SimpleNamespace:
    """Set-up up to the first step: the inputs, the trainer holding the
    seeded weights and a rebuilt cluster table, its draws seeded."""
    from intrinsicnerf_tpu_torch import train_object as port_cli
    from intrinsicnerf_tpu_torch.train import prepare as port_prepare
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    dev, config, traffic = bench.device, bench.config, bench.traffic
    arch, hp, ds = rconf.arch(config), rconf.hyper(config), config["dataset"]
    h, w, focal = ds["height"], ds["width"], forward_facing.focal(ds)
    # the depth range the LLFF loader sets: [0, 1] in NDC
    cfg = dataclasses.replace(system.framework_config(config, bench.workdir),
                              depth_range=(ds["near"], ds["far"]))
    data = forward_facing.train_data(ds, scenes.generator(bench.seed, 1, dev), dev)
    weights = scenes.make_weights(arch, scenes.generator(bench.seed, 2, dev), dev)
    world = forward_facing.view_rays(ds, scenes.generator(bench.seed, 3, dev),
                                     traffic["rebuild_views"], dev)
    ndc_focal = port_cli.ndc_focal_for(cfg, types.SimpleNamespace(focal=focal))
    cluster_rays = (world if ndc_focal is None
                    else port_prepare.apply_ndc_to_rays(world, h, w, ndc_focal))
    bundle = system.scene_bundle(config, data, cluster_rays)
    sample_fn = port_trainer.make_object_sample_fn(cfg, bundle, ndc_focal=ndc_focal)
    trainer = port_trainer.Trainer(cfg, bundle, seed=bench.seed, device=dev, sample_fn=sample_fn)
    system.load_weights(trainer.state, weights)
    trainer.rebuild_clusters(hp["vis_every"], save=False)
    w_c, b_f = rconf.cluster_anneal(hp, hp["vis_every"])
    draw_seed = (bench.seed * 7919 + 17) % (1 << 62)
    trainer.generator.manual_seed(draw_seed)
    k = cfg.train.steps_per_call
    return types.SimpleNamespace(
        arch=arch, hp=hp, k=k, data=data, weights=weights, trainer=trainer, sample_fn=sample_fn,
        pools=bundle.pools, focal=focal, cluster_rays=ndc.project(world, h, w, focal),
        table=system.table_copy(trainer.table), w_c=w_c, b_f=b_f, draw_seed=draw_seed,
        observe=tuple(range(k, traffic["first_steps"] + k, k)))


def ray_draws(p, device):
    """The trainer's sampler's draw and the reference's, from one seed:
    (rays, colours, masks) each."""
    seed = p.draw_seed + 1
    b = p.sample_fn(torch.Generator(device=device).manual_seed(seed), p.pools, 0)
    ref = ndc.draw_batch(torch.Generator(device=device).manual_seed(seed), p.data, p.hp, p.focal,
                         0)
    return (b.rays, b.rgb, b.semantic), (ref["rays"], ref["rgb"], ref["label"])


def run(bench) -> dict:
    dev, traffic = bench.device, bench.traffic
    train = base(bench)
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
        train._sync(dev)
        calls += 1
    block = k * max(1, round(traffic["block_s"] / ((time.perf_counter() - t0) / calls)))

    enqueue = []
    trainer.step_hook = lambda done, t_s, t_e, work: enqueue.append(t_e - t_s)
    train._sync(dev)
    t_window = time.perf_counter()
    start = trainer.global_step
    while time.perf_counter() - t_window < bench.seconds:
        report = trainer.fit(trainer.global_step + block, progress=False)
    train._sync(dev)
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
    draws = ray_draws(p, dev)

    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    trainer.close()
    del trainer
    p.trainer = None
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    ref_table, albedo, label = train.reference_table(p)
    ref_losses, ref_grads, ref_params = ndc.follow(
        weights, p.data, p.draw_seed, n_first, arch, hp, p.focal, ref_table, p.w_c,
        observe=tuple(losses))
    checks = compare.train_numbers(losses, ref_losses, grads, ref_grads,
                                   compare.delta(after, weights),
                                   compare.delta(ref_params, weights))
    checks["table"] = compare.table_gap(p.table, ref_table, albedo, label)
    checks["rays"] = ndc.ray_gap(*draws)
    rays = 2 * hp["n_rays"]
    record = types.SimpleNamespace(
        arch=arch, hp=hp, kind="train", window_s=window_s, steps=steps, rays_per_step=rays,
        enqueue_s=sum(enqueue), summary=summary)
    return {"t_window": t_window, "attempted": steps, "failed": 0 if finite else steps,
            "e2e": {"train_rays_per_s": steps * rays / window_s},
            "checks": checks, "memory_peak_bytes": peak, "record": record}
