"""The port's data-parallel layer (``intrinsicnerf_tpu_torch/parallel``)
against the JAX package's ``parallel`` on the CPU.

- The padding, slicing and sharding helpers against the JAX functions on
  the same numpy inputs: exact (they copy and index).
- A gloo process group of one rank in this process: the data-parallel
  step (gradient and loss-term all-reduces, sum then divide by 1) is
  bitwise equal to the step with no group over 3 steps, on the packed
  and the unpacked state, and a data-parallel ``Trainer`` (padded and
  sharded pools, the state broadcast, the split render) is bitwise equal
  to the plain one through a rebuild, an evaluation and a checkpoint.
- Two gloo ranks (``tests/_torch_parallel_worker.py``, a hard time
  limit per rig) render 37 rays with chunk 16, each rank 19 of the
  padded 38, and gather them: bitwise equal to ``render_rays_chunked`` at
  chunk 16 in one process (every ray of a view is independent).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from intrinsicnerf_tpu.parallel import distributed as jdist
from intrinsicnerf_tpu.parallel import mesh as jmesh
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.parallel import distributed as tdist
from intrinsicnerf_tpu_torch.parallel import mesh as tmesh
from intrinsicnerf_tpu_torch.parallel.sharded_render import make_sharded_render
from intrinsicnerf_tpu_torch.parallel.sharded_step import make_sharded_train_step, rank_seed
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.train import step as tstep
from tests._torch_parallel_worker import free_port, spawn_ranks

H, W = 6, 8


def _np_pools(rng, n_img, pose=False):
    if pose:
        return jstep.PosePools(
            dirs_cam=rng.normal(size=(H * W, 3)).astype(np.float32),
            poses=rng.normal(size=(n_img, 4, 4)).astype(np.float32),
            rgb=rng.uniform(size=(n_img, H * W, 3)).astype(np.float32),
            mask=(rng.uniform(size=(n_img, H * W)) > 0.5).astype(np.float32))
    return jstep.DataPools(
        rays=rng.normal(size=(n_img, H * W, 11)).astype(np.float32),
        rgb=rng.uniform(size=(n_img, H * W, 3)).astype(np.float32),
        depth=None,
        semantic=rng.integers(0, 5, size=(n_img, H * W)).astype(np.int64),
        mask_ids=np.arange(n_img, dtype=np.int64) % 2)


def _port(pools):
    cls = tstep.PosePools if isinstance(pools, jstep.PosePools) else tstep.DataPools
    return cls(*(None if x is None else torch.from_numpy(np.asarray(x)) for x in pools))


@pytest.mark.parametrize("pose", [False, True], ids=["DataPools", "PosePools"])
@pytest.mark.parametrize("n_img,n", [(5, 8), (3, 2), (4, 4), (1, 3)])
def test_pad_images_to_multiple_matches_jax(pose, n_img, n):
    pools = _np_pools(np.random.default_rng(n_img * 10 + n), n_img, pose)
    want = jmesh.pad_images_to_multiple(pools, n)
    got = tmesh.pad_images_to_multiple(_port(pools), n)
    for f in type(pools)._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    if pose:  # the shared leaf keeps its shape
        assert got.dirs_cam.shape == (H * W, 3)


@pytest.mark.parametrize("pose", [False, True], ids=["DataPools", "PosePools"])
def test_pool_specs_match_jax(pose):
    pools = _np_pools(np.random.default_rng(0), 4, pose)
    want = jmesh.pool_specs(pools)
    got = tmesh.pool_specs(_port(pools))
    word = {jax.sharding.PartitionSpec(): "replicate", jax.sharding.PartitionSpec("data"): "shard"}
    assert tuple(got) == tuple(None if s is None else word[s] for s in want)
    assert (got.dirs_cam == "replicate") if pose else (got.depth is None)


@pytest.mark.parametrize("pose", [False, True], ids=["DataPools", "PosePools"])
def test_shard_pools_keeps_each_rank_the_jax_shard(pose):
    """Rank r's pools are what the JAX ``shard_pools`` puts on device r of
    a 2-device mesh (image-axis fields split, ``dirs_cam`` whole)."""
    pools = _np_pools(np.random.default_rng(1), 4, pose)
    placed = jmesh.shard_pools(jmesh.make_mesh(2), pools)
    for rank in range(2):
        group = tmesh.DataGroup(rank, 2, "gloo", torch.device("cpu"))
        got = tmesh.shard_pools(group, _port(pools))
        for f in type(pools)._fields:
            x = getattr(placed, f)
            if x is None:
                assert getattr(got, f) is None
                continue
            shard = next(s for s in x.addressable_shards if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(shard.data),
                                          err_msg=f"{f} rank {rank}")
    with pytest.raises(ValueError, match="pad them"):
        tmesh.shard_pools(tmesh.DataGroup(0, 3, "gloo", torch.device("cpu")), _port(pools))


@pytest.mark.parametrize("n_ids,world", [(7, 2), (12, 4), (3, 4), (5, 1)])
def test_image_id_padding_and_slices_match_jax(n_ids, world, monkeypatch):
    ids = list(range(100, 100 + 5 * n_ids, 5))
    assert tdist.pad_ids_to_multiple(ids, world) == jdist.pad_ids_to_multiple(ids, world)
    padded = len(tdist.pad_ids_to_multiple(ids, world))
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        assert tdist.local_image_slice(padded, rank, world) == jdist.local_image_slice(padded)
        assert tdist.local_train_ids(ids, world, rank) == jdist.local_train_ids(ids, world)
    if padded % (world + 1):
        with pytest.raises(ValueError, match="pad the id list"):
            tdist.local_image_slice(padded, 0, world + 1)


def test_backends_follow_the_device(monkeypatch):
    assert tdist.backend_for("cuda") == "nccl" and tdist.backend_for("cpu") == "gloo"
    assert not dist.is_initialized() and tdist.is_lead_process()
    group = tmesh.make_group("cpu")  # no process group: one rank, no collectives
    assert (group.rank, group.world, group.backend, group.process_group) == (0, 1, None, None)
    assert tdist.initialize_distributed(device="cpu") == (0, 1) and not dist.is_initialized()


# ---- one gloo rank in this process ----------------------------------------


@pytest.fixture(scope="module")
def world1():
    """A gloo process group of one rank, destroyed after the module."""
    torch.sin(torch.linspace(0, 1, 1 << 16))  # the process's first parallel sin, off the record
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    yield tmesh.make_group("cpu")
    dist.destroy_process_group()


def test_make_group_holds_the_backend_to_the_device(world1, monkeypatch):
    assert (world1.rank, world1.world, world1.backend) == (0, 1, "gloo") and world1.lead
    assert tdist.is_lead_process()
    assert tdist.initialize_distributed(device="cpu") == (0, 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    with pytest.raises(RuntimeError, match="needs the gloo backend"):
        tmesh.make_group("cpu")


def _small_pools(rng, n_img=3):
    c2w = np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1))
    c2w[:, 2, 3] = -3.0 - 0.1 * np.arange(n_img)
    from intrinsicnerf_tpu_torch.core.rays import create_rays

    rays = create_rays(torch.from_numpy(c2w), H, W, 5.0, 5.0, (W - 1) / 2, (H - 1) / 2, 1.0, 6.0)
    return tstep.DataPools(
        rays=rays, rgb=torch.from_numpy(rng.uniform(size=(n_img, H * W, 3)).astype(np.float32)),
        depth=torch.from_numpy(rng.uniform(1, 5, size=(n_img, H * W)).astype(np.float32)),
        semantic=torch.from_numpy(rng.integers(0, 5, size=(n_img, H * W))),
        mask_ids=torch.ones(n_img, dtype=torch.int64))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_world1_step_is_bitwise_the_plain_step(world1, packed):
    """Three steps with random draws (perturb and sigma noise on) from one
    seed: every report term, parameter and Adam tensor bitwise equal; the
    collectives ran once each per step."""
    mcfg = tm.MLPConfig(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=4,
                        use_fused_kernel=True, compute_dtype=torch.bfloat16)
    if not packed:
        mcfg = dataclasses.replace(mcfg, depth=4, width=32, skips=(2,), use_fused_kernel=False,
                                   compute_dtype=torch.float32)
    rcfg = tp.RenderConfig(n_coarse=4, n_importance=4, raw_noise_std=1.0)
    tcfg = tstep.TrainConfig(n_rays=6)
    pools = _small_pools(np.random.default_rng(2))
    table = empty_cluster_table(4, 8, device="cpu")
    runs = []
    for group in (None, world1):
        state = tstep.create_train_state(mcfg, tcfg, device="cpu",
                                         generator=torch.Generator().manual_seed(4))
        assert isinstance(state.model_fine, tm.PackedMLP) == packed
        if group is None:
            step = tstep.make_train_step(mcfg, rcfg, tcfg, H, W)
        else:
            tmesh.replicate(group, state)
            step = make_sharded_train_step(mcfg, rcfg, tcfg, H, W, group)
            for c in (tmesh.reduce_grads, tmesh.reduce_terms):
                c.launches = 0
        gen = torch.Generator().manual_seed(rank_seed(9, 0))
        reports = [torch.stack(list(step(state, pools, table, 0.3, gen))) for _ in range(3)]
        opt = state.optimizer
        runs.append((reports, [p.detach().clone() for g in opt.param_groups for p in g["params"]],
                     [v.clone() for s in opt.state.values() for v in s.values()]))
    assert (tmesh.reduce_grads.launches, tmesh.reduce_terms.launches) == (3, 3)
    (ra, pa, aa), (rb, pb, ab) = runs
    assert all(torch.equal(x, y) for x, y in zip(ra, rb)), "report"
    assert all(torch.equal(x, y) for x, y in zip(pa, pb)), "parameters"
    assert len(aa) == len(ab) and all(torch.equal(x, y) for x, y in zip(aa, ab)), "adam"
    assert all(torch.isfinite(r).all() for r in ra)


def test_world1_trainer_is_bitwise_the_plain_trainer(world1, tmp_path):
    """The data-parallel ``Trainer`` at one rank against the plain one from
    one seed: 4 steps with a rebuild at 2 and 4 (the split render feeding
    mean-shift), an evaluation and a checkpoint at 4; the same state,
    palette, metrics and checkpoint, and a resume that restores it."""
    from intrinsicnerf_tpu_torch.cluster import meanshift
    from intrinsicnerf_tpu_torch.config import ExperimentConfig, FrameworkConfig, LoggingConfig
    from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, Trainer

    meanshift_native = meanshift._native
    meanshift._native = lambda: None
    try:
        pools = _small_pools(np.random.default_rng(5), n_img=3)
        gt = {"image": np.random.default_rng(6).uniform(size=(1, H, W, 3)).astype(np.float32)}
        bundle = SceneBundle(pools=pools, rays_vis=pools.rays[:2], rays_test=pools.rays[2:],
                             h=H, w=W, h_scaled=H, w_scaled=W, num_valid_classes=4, test_gt=gt)
        mcfg = tm.MLPConfig(depth=3, width=32, skips=(1,), n_freqs_pos=4, n_freqs_dir=2,
                            enable_semantic=True, num_semantic_classes=4)
        out = {}
        for name, group in (("plain", None), ("group", world1)):
            cfg = FrameworkConfig(
                experiment=ExperimentConfig(save_dir=str(tmp_path / name), enable_semantic=True),
                mlp=mcfg, render=tp.RenderConfig(n_coarse=8, n_importance=8, raw_noise_std=1.0),
                train=tstep.TrainConfig(n_rays=8, n_iters=4), chunk=20,
                logging=LoggingConfig(step_log_tfb=2, step_save_ckpt=4, step_vis_train=2,
                                      step_val=4))
            with Trainer(cfg, bundle, seed=3, device="cpu", group=group) as t:
                report = t.fit(progress=False)
                metrics = t.evaluate(4, save=False)
                st = t.state
                out[name] = (torch.stack(list(report)),
                             [p.detach().clone() for m in (st.model_coarse, st.model_fine)
                              for p in m.parameters()],
                             [x.clone() for x in t.table[:4]], metrics,
                             t.generator.get_state())
            ck = torch.load(tmp_path / name / "checkpoints" / "000004.ckpt", weights_only=False)
            out[name] += (ck,)
        (ra, pa, ta, ma, ga, ca), (rb, pb, tb, mb, gb, cb) = out["plain"], out["group"]
        assert torch.equal(ra, rb) and ma == mb and torch.equal(ga, gb)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
        assert all(torch.equal(x, y) for x, y in zip(ta, tb)) and bool(ta[3].any())
        assert torch.equal(cb["generator_states"][0], ca["generator_state"])
        assert len(cb["generator_states"]) == 1
        with Trainer(cfg, bundle, seed=3, device="cpu", group=world1) as t:
            assert t.maybe_resume() == 4
            assert torch.equal(t.generator.get_state(), gb)
            assert all(torch.equal(p.detach(), q) for p, q in zip(
                [p for m in (t.state.model_coarse, t.state.model_fine) for p in m.parameters()],
                pb))
    finally:
        meanshift._native = meanshift_native


def test_checkpoint_generators_follow_the_world(tmp_path, capsys):
    """A file with every rank's generator restores rank r's at the same
    world size; at another it leaves the fresh seed and says so."""
    from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer

    mcfg = tm.MLPConfig(depth=3, width=16, skips=(1,))
    state = tstep.create_train_state(mcfg, tstep.TrainConfig(), device="cpu")
    gens = [torch.Generator().manual_seed(rank_seed(3, r)) for r in range(2)]
    for g in gens:
        torch.rand(5, generator=g)
    ck = Checkpointer(str(tmp_path))
    ck.save(state, 7, gens[0], generator_states=[g.get_state() for g in gens])
    for rank in range(2):
        g = torch.Generator().manual_seed(0)
        assert ck.restore(state, generator=g, rank=rank, world=2) == 7
        assert torch.equal(g.get_state(), gens[rank].get_state())
    fresh = torch.Generator().manual_seed(rank_seed(3, 0))
    ck.restore(state, generator=fresh, rank=0, world=1)
    assert torch.equal(fresh.get_state(), torch.Generator().manual_seed(rank_seed(3, 0)).get_state())
    assert "checkpoint of 2 rank(s) resumed at 1" in capsys.readouterr().out
    ck.close()


def _render_spec(n_rays=37, chunk=16):
    rng = np.random.default_rng(9)
    rays = np.zeros((n_rays, 11), np.float32)
    rays[:, 3:6] = rng.normal(size=(n_rays, 3))
    rays[:, 8:11] = rays[:, 3:6] / np.linalg.norm(rays[:, 3:6], axis=-1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.1, 5.0
    return {"mcfg": dict(depth=3, width=32, skips=(1,), n_freqs_pos=4, n_freqs_dir=2,
                         enable_semantic=True, num_semantic_classes=4),
            "seed": 11, "rays": torch.from_numpy(rays), "chunk": chunk,
            "render_rcfg": dict(n_coarse=8, n_importance=8),
            "fields": ("rgb", "depth", "acc", "albedo", "shading", "residual", "sem_logits",
                       "weights")}


def _chunked(spec):
    from tests._torch_parallel_worker import _models

    mcfg, mc, mf = _models(spec)
    with torch.no_grad():
        out = tp.render_rays_chunked(mc, mf, mcfg, spec["rays"],
                                     tp.RenderConfig(**spec["render_rcfg"]), spec["chunk"])
    return {k: getattr(out.fine, k) for k in spec["fields"]}


def test_world1_sharded_render_is_the_chunked_render(world1):
    spec = _render_spec()
    from tests._torch_parallel_worker import case_render

    tmesh.all_gather_rows.launches = 0
    got, want = case_render(world1, spec), _chunked(spec)
    assert all(torch.equal(got[k], want[k]) for k in spec["fields"])
    n_tensors = 2 * 11 + 1 - 2  # every tensor of both levels' maps and z_std (no feat, no sigma)
    assert tmesh.all_gather_rows.launches == n_tensors
    with pytest.raises(ValueError, match="made for 37 rays"):
        make_sharded_render(tm.MLPConfig(), tp.RenderConfig(), world1, 37)(None, None,
                                                                           spec["rays"][:5])


def test_two_rank_sharded_render_is_the_chunked_render(tmp_path):
    """37 rays over 2 gloo ranks, chunk 16 (each rank 19 rays: chunks of
    16 and 3), gathered on both: bitwise the one-process render at chunk
    16 (chunks of 16, 16 and 5); rays are independent, so the chunking
    changes no ray's arithmetic."""
    spec = _render_spec()
    torch.save(spec, tmp_path / "render.pt")
    ranks = spawn_ranks("render", 2, str(tmp_path / "render.pt"), str(tmp_path))
    want = _chunked(spec)
    for k in spec["fields"]:
        assert ranks[0][k].shape[0] == 37
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        assert torch.equal(ranks[0][k], want[k]), (k, float((ranks[0][k] - want[k]).abs().max()))
