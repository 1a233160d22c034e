"""One rank of the port's data-parallel test rig on the CPU (gloo).

Usage: python tests/_torch_parallel_worker.py CASE INIT_METHOD WORLD RANK IN.pt OUT.pt

``spawn_ranks`` starts WORLD of these, one per rank, with a hard time
limit that kills them all.  The cases read their inputs from ``IN.pt``
(made by the test with ``torch.save``: plain values and tensors, no JAX)
and write what the test compares to ``OUT.pt``:

- ``render``: a seeded model's view through ``make_sharded_render``;
- ``multihost``: the class-set and pixel allgathers, then for each step
  spec two data-parallel Adam steps at fixed draws (each rank its own
  local image) and a 37-ray sharded render of the trained models;
- ``cli``: the scene CLI's trainer (``train_scene.build_trainer``) with
  the given arguments, resumed and fitted, and the state it ends in.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(case: str, world: int, in_path: str, out_dir: str, timeout: float = TIMEOUT_S):
    """Run ``case`` on ``world`` gloo ranks; the ranks' outputs in rank
    order.  A rank that fails, or a rig past ``timeout`` seconds, kills
    every rank and raises with the ranks' output."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    outs = [os.path.join(out_dir, f"{case}_rank{r}.pt") for r in range(world)]
    logs = [open(os.path.join(out_dir, f"{case}_rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, init, str(world),
                               str(r), in_path, outs[r]], env=env, cwd=REPO, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-4000:]}")
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"the {case} rig failed:\n" + "\n".join(text))
    return [torch.load(o, weights_only=False) for o in outs]


def _models(spec):
    from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig

    mcfg = MLPConfig(**spec["mcfg"])
    g = torch.Generator().manual_seed(spec["seed"])
    return mcfg, IntrinsicMLP(mcfg, device="cpu", generator=g), IntrinsicMLP(
        mcfg, device="cpu", generator=g)


def _render(group, spec, mcfg, mc, mf):
    from intrinsicnerf_tpu_torch.parallel.sharded_render import make_sharded_render
    from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig

    rays = spec["rays"]
    render = make_sharded_render(mcfg, RenderConfig(**spec["render_rcfg"]), group,
                                 rays.shape[0], chunk=spec["chunk"])
    with torch.no_grad():
        out = render(mc, mf, rays)
    return {name: getattr(out.fine, name) for name in spec["fields"]}


def case_render(group, spec):
    mcfg, mc, mf = _models(spec)
    return _render(group, spec, mcfg, mc, mf)


def _load_level(model, init):
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP

    with torch.no_grad():
        if isinstance(model, PackedMLP):
            model.weight.copy_(init["weight"])
            model.bias.copy_(init["bias"])
        else:
            model.load_state_dict(init)


def _level_state(model):
    from intrinsicnerf_tpu_torch.models.mlp import PackedMLP

    if isinstance(model, PackedMLP):
        return {"weight": model.weight.detach().clone(), "bias": model.bias.detach().clone()}
    return {k: v.clone() for k, v in model.state_dict().items()}


def _step_case(group, c):
    from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table
    from intrinsicnerf_tpu_torch.data.samplers import gather_ray_pairs
    from intrinsicnerf_tpu_torch.models.mlp import MLPConfig
    from intrinsicnerf_tpu_torch.parallel import mesh
    from intrinsicnerf_tpu_torch.parallel.sharded_step import make_sharded_train_step, rank_generator
    from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
    from intrinsicnerf_tpu_torch.train.step import DataPools, TrainConfig, create_train_state

    mcfg, tcfg = MLPConfig(**c["mcfg"]), TrainConfig(**c["tcfg"])
    h, w = c["hw"]
    pools = mesh.shard_pools(group, mesh.pad_images_to_multiple(DataPools(**c["pools"]),
                                                                group.world))
    state = create_train_state(mcfg, tcfg, device="cpu")
    # rank 0 holds the JAX weights, the others garbage: replicate must fix it
    for model, init in zip((state.model_coarse, state.model_fine), c["init"]):
        _load_level(model, init)
        if group.rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
    mesh.replicate(group, state)
    img = torch.tensor(0)

    def sample_fn(generator, p, step):  # fixed draws from this rank's first image
        return gather_ray_pairs(p.rays, p.rgb, h, w, img, *c["draws"], depth_pool=p.depth,
                                sem_pool=p.semantic, mask_ids=p.mask_ids)

    step = make_sharded_train_step(mcfg, RenderConfig(**c["rcfg"]), tcfg, h, w, group,
                                   sample_fn=sample_fn)
    table = empty_cluster_table(c["table_classes"], 32, device="cpu")
    gen = rank_generator(0, group)
    reports = [torch.stack(list(step(state, pools, table, 0.0, gen))) for _ in range(c["steps"])]
    return {"reports": torch.stack(reports),
            "levels": [_level_state(m) for m in (state.model_coarse, state.model_fine)],
            "adam": [{k: v.clone() for k, v in s.items()}
                     for s in state.optimizer.state_dict()["state"].values()],
            "mcfg": mcfg, "models": (state.model_coarse, state.model_fine)}


def case_multihost(group, spec):
    from intrinsicnerf_tpu_torch.parallel import mesh
    from intrinsicnerf_tpu_torch.parallel.distributed import (
        allgather_pixels, allgather_semantic_classes)

    out = {"classes": allgather_semantic_classes(spec["classes"][group.rank]),
           "pixels": allgather_pixels([a for a in spec["pixels"][group.rank]])}
    for name in ("reduce_grads", "reduce_terms", "all_gather_rows"):
        getattr(mesh, name).launches = 0
    for name, c in spec["steps"].items():
        res = _step_case(group, c)
        mc, mf = res.pop("models")
        res["render"] = _render(group, spec, res.pop("mcfg"), mc, mf)
        out[name] = res
    out["collectives"] = {n: getattr(mesh, n).launches
                          for n in ("reduce_grads", "reduce_terms", "all_gather_rows")}
    out["rank"] = group.rank
    return out


def case_cli(rank, spec):
    """The scene CLI's trainer on this rank, as ``train_scene.main`` runs
    it (``{rank}`` in an argument becomes the rank); the state it ends in."""
    from intrinsicnerf_tpu_torch import train_scene
    from intrinsicnerf_tpu_torch.cluster import meanshift

    meanshift._native = lambda: None  # the numpy mean-shift: no build in the rig
    argv = [a.replace("{rank}", str(rank)) for a in spec["argv"]]
    args = train_scene.parse_args(argv)
    _, _, trainer = train_scene.build_trainer(args)
    with trainer:
        start = trainer.maybe_resume()
        trainer.fit(n_iters=spec["n_iters"], progress=False)
        st = trainer.state
        return {"start": start, "step": trainer.global_step, "lead": trainer.lead,
                "logger": type(trainer.logger).__name__,
                "params": [p.detach().clone() for m in (st.model_coarse, st.model_fine)
                           for p in m.parameters()],
                "adam": st.optimizer.state_dict()["state"],
                "table": [t.clone() for t in trainer.table[:4]],
                "anneal": (trainer.w_c, trainer.b_f),
                "generator": trainer.generator.get_state(),
                "pool_images": trainer.bundle.pools.rgb.shape[0],
                "classes": trainer.bundle.num_valid_classes}


def main(argv):
    import torch.distributed as dist

    from intrinsicnerf_tpu_torch.parallel.mesh import make_group

    case, init, world, rank, in_path, out_path = argv
    torch.set_num_threads(2)
    torch.sin(torch.linspace(0, 1, 1 << 16))  # the process's first parallel sin, off the record
    spec = torch.load(in_path, weights_only=False)
    if case == "cli":  # the CLI joins the group itself
        spec["argv"] += ["--coordinator", init, "--num_processes", world, "--process_id", rank]
        result = case_cli(int(rank), spec)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank))
        result = {"render": case_render, "multihost": case_multihost}[case](make_group("cpu"),
                                                                            spec)
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.save(result, out_path)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
