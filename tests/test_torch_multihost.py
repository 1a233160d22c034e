"""Two processes of the port's data-parallel path (gloo on the CPU), the
twin of ``tests/test_multihost.py`` and ``tests/_multihost_worker.py``.

Each rank (``tests/_torch_parallel_worker.py``, a hard time limit per
rig that kills both) joins a two-rank gloo group and:

- takes the union of class sets that differ between the ranks
  (``allgather_semantic_classes``) and gathers pixel blocks of uneven row
  counts (``allgather_pixels``);
- takes two data-parallel Adam steps from the JAX package's initial
  weights (rank 1 starts from other weights, which the broadcast must
  replace), each rank on its shard of four images with fixed draws from
  its first image (perturb 0, no sigma noise: no random draw anywhere),
  then renders 37 rays split over the ranks.

The ranks agree bitwise on the losses, the parameters, Adam's state and
the gathered render.  Against JAX's ``make_sharded_train_step`` on a
2-device mesh with the same draws:

- the small unfused fp32 config: every loss term of both steps within
  1e-5 (``test_torch_train.py``'s bound for one unfused step) and every
  parameter after the two steps within 1e-4 of the largest
  (``test_torch_multi_step.py``'s bound after Adam steps);
- the fused 8x256 config on the packed state (JAX: Pallas in interpret
  mode; the port: the kernels' plain versions): every loss term within
  1e-3 relative (``test_torch_train.py``'s fused bound; in the second
  step, whose weights already differ at the bf16 level, a term that is
  under 1e-6 of the total is held within 1e-6 of the total), each level's
  parameter move (after - before) at cosine > 0.999 with JAX's (the
  fused gradients' bound there), and the padded slots exactly zero.

Then the scene CLI on two ranks (``--coordinator``, host-local loading):
8 steps with rebuilds at 4 and 8 and a checkpoint at 4 and 8, each rank
told to write to its own directory, of which only rank 0's exists after;
both ranks end with the same state and cluster table; and a resume of
the step-4 checkpoint and palette on both ranks ends bitwise where the
uninterrupted run did, each rank with its own generator.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from intrinsicnerf_tpu.cluster.assign import empty_cluster_table
from intrinsicnerf_tpu.data.samplers import RayBatch
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.ops import fused_mlp as jf
from intrinsicnerf_tpu.parallel.mesh import make_mesh, replicate, shard_pools
from intrinsicnerf_tpu.parallel.sharded_step import make_sharded_train_step
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu.train.schedules import make_lr_schedule
from intrinsicnerf_tpu_torch.tools.import_ckpt import packed_from_jax, params_from_jax
from intrinsicnerf_tpu_torch.utils.image import imwrite
from tests._torch_parallel_worker import spawn_ranks
from tests.test_train_step import H, W, make_pools

PAIRS = {"small": 8, "packed": 4}
SMALL = dict(depth=3, width=32, skips=(1,), n_freqs_pos=4, n_freqs_dir=2, enable_semantic=True,
             num_semantic_classes=4)
PACKED = dict(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=4,
              use_fused_kernel=True)
RCFG = {"small": dict(n_coarse=8, n_importance=8, perturb=0.0, raw_noise_std=0.0),
        "packed": dict(n_coarse=4, n_importance=8, perturb=0.0, raw_noise_std=0.0)}
STEPS = 2


def _draws(n):
    rng = np.random.default_rng(n)
    idx = rng.integers(0, H * W, size=n)
    bh, bw = rng.integers(-1, 2, size=n), rng.integers(-1, 2, size=n)
    nei = np.clip(idx // W + bh, 0, H - 1) * W + np.clip(idx % W + bw, 0, W - 1)
    return (idx, bh, bw), np.concatenate([idx, nei])


def _lift(p):  # a sigma bias above zero, so both levels render from the first step
    if jf.is_packed(p):
        return {**p, "b_sig": p["b_sig"].at[0, 0].add(2.0)}
    return {**p, "sigma": {**p["sigma"], "bias": p["sigma"]["bias"] + 2.0}}


def _jax_run(name, pools):
    """Two JAX data-parallel steps on a 2-device mesh with the fixed draws:
    (initial params, params after, the reports)."""
    jcfg = jm.MLPConfig(**(SMALL if name == "small" else
                           dict(PACKED, compute_dtype=jnp.bfloat16)))
    tcfg = jstep.TrainConfig(n_rays=PAIRS[name])
    opt = optax.adam(make_lr_schedule(tcfg.lrate, tcfg.lrate_decay))
    state = jstep.create_train_state(jax.random.key(7), jcfg, tcfg, opt)
    params = {"coarse": _lift(state.params_coarse), "fine": _lift(state.params_fine)}
    state = state._replace(params_coarse=params["coarse"], params_fine=params["fine"],
                           opt_state=opt.init(params))
    init = jax.tree_util.tree_map(np.asarray, params)
    _, idx = _draws(PAIRS[name])

    def sample_fn(key, p, step):  # the same pixels of each device's first image
        def take(pool):
            return pool[0][idx]
        return RayBatch(rays=take(p.rays), rgb=take(p.rgb), depth=take(p.depth),
                        semantic=take(p.semantic), sem_flag=p.mask_ids[0].astype(jnp.float32),
                        image_idx=jnp.int32(0))

    mesh = make_mesh(2)
    sharded = shard_pools(mesh, pools)
    step = make_sharded_train_step(jm_cfg := jcfg, jp.RenderConfig(**RCFG[name]), tcfg, opt, H, W,
                                   mesh, sharded, sample_fn=sample_fn)
    state = replicate(mesh, state)
    table = replicate(mesh, empty_cluster_table(4, 32))
    reports = []
    for i in range(STEPS):
        state, rep = step(state, sharded, table, jnp.float32(0.0), jax.random.key(i))
        reports.append(np.array([float(x) for x in rep]))
    after = jax.tree_util.tree_map(np.asarray, {"coarse": state.params_coarse,
                                                "fine": state.params_fine})
    return jm_cfg, init, after, np.stack(reports)


def _port_level(p):
    p = jax.tree_util.tree_map(np.asarray, p)
    if jf.is_packed(p):
        flat = packed_from_jax(p, "cpu")
        return {"weight": flat.weight, "bias": flat.bias}
    return params_from_jax(p, "cpu")


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mh")
    pools = jax.tree_util.tree_map(np.asarray, make_pools(n_img=4, semantic=True))
    jax_runs, steps = {}, {}
    for name in ("small", "packed"):
        jcfg, init, after, reports = _jax_run(name, pools)
        jax_runs[name] = (jcfg, init, after, reports)
        draws, _ = _draws(PAIRS[name])
        mcfg = SMALL if name == "small" else dict(PACKED, compute_dtype=torch.bfloat16)
        steps[name] = {
            "mcfg": mcfg, "tcfg": dict(n_rays=PAIRS[name]), "rcfg": RCFG[name], "hw": (H, W),
            "pools": {k: torch.from_numpy(np.array(v)) for k, v in pools._asdict().items()},
            "init": [_port_level(init["coarse"]), _port_level(init["fine"])],
            "draws": [torch.from_numpy(d) for d in draws], "table_classes": 4, "steps": STEPS}
    rng = np.random.default_rng(3)
    spec = {"steps": steps,
            "classes": [np.array([0, 3, 3, 9]), np.array([1, 3, 40])],
            "pixels": [[rng.uniform(size=(5, 3)).astype(np.float32), np.arange(5)],
                       [rng.uniform(size=(2, 3)).astype(np.float32), np.arange(7, 9)]],
            **{k: v for k, v in _render_spec().items() if k != "mcfg"}}
    torch.save(spec, tmp / "multihost.pt")
    ranks = spawn_ranks("multihost", 2, str(tmp / "multihost.pt"), str(tmp), timeout=240)
    return ranks, jax_runs, spec


def _render_spec():
    from tests.test_torch_parallel import _render_spec as spec

    return spec()


def test_ranks_agree_bitwise(rig):
    (a, b), _, spec = rig
    assert (a["rank"], b["rank"]) == (0, 1)
    for name in ("small", "packed"):
        assert torch.equal(a[name]["reports"], b[name]["reports"]), name
        for la, lb in zip(a[name]["levels"], b[name]["levels"]):
            assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la), name
        for sa, sb in zip(a[name]["adam"], b[name]["adam"]):
            assert all(torch.equal(sa[k], sb[k]) for k in sa), name
        for k in spec["fields"]:
            assert torch.equal(a[name]["render"][k], b[name]["render"][k]), (name, k)
            assert a[name]["render"][k].shape[0] == 37
    # per step one gradient and one loss-term all-reduce; a gather per map tensor
    assert a["collectives"] == b["collectives"]
    assert a["collectives"]["reduce_grads"] == a["collectives"]["reduce_terms"] == 2 * STEPS


def test_allgathers_take_the_union_and_uneven_rows(rig):
    (a, b), _, spec = rig
    for r in (a, b):
        np.testing.assert_array_equal(r["classes"], [0, 1, 3, 9, 40])
        np.testing.assert_array_equal(r["pixels"][0], np.concatenate([p[0] for p in spec["pixels"]]))
        np.testing.assert_array_equal(r["pixels"][1], [0, 1, 2, 3, 4, 7, 8])


def test_small_config_matches_jax_sharded_step(rig):
    (a, _), jax_runs, _ = rig
    jcfg, _, after, reports = jax_runs["small"]
    np.testing.assert_allclose(a["small"]["reports"].numpy(), reports, rtol=0, atol=1e-5)
    ref = [_port_level(after["coarse"]), _port_level(after["fine"])]
    scale = max(float(v.abs().max()) for lvl in ref for v in lvl.values())
    for got, want in zip(a["small"]["levels"], ref):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=k)


def test_packed_config_matches_jax_sharded_step(rig):
    (a, _), jax_runs, _ = rig
    jcfg, init, after, reports = jax_runs["packed"]
    got_r = a["packed"]["reports"].numpy()
    assert np.isfinite(got_r).all()
    for i in range(STEPS):
        # the first step from the same weights at the single-step bound; the
        # second after Adam moved both by gradients that agree to the bf16
        # kernels' cosine: a term under 1e-6 of the total carries no weight
        floor = 1e-6 if i == 0 else 1e-6 * abs(reports[i][0]) / 1e-3
        for j, (x, y) in enumerate(zip(got_r[i], reports[i])):
            assert abs(x - y) <= 1e-3 * max(abs(y), floor), (i, j, x, y)
    from intrinsicnerf_tpu_torch.models.mlp import MLPConfig, PackedMLP

    masks = PackedMLP(MLPConfig(**dict(PACKED, compute_dtype=torch.bfloat16)), device="cpu")
    for level, got in zip(("coarse", "fine"), a["packed"]["levels"]):
        before, ref = _port_level(init[level]), _port_level(after[level])
        move = torch.cat([got["weight"] - before["weight"], got["bias"] - before["bias"]])
        move_j = torch.cat([ref["weight"] - before["weight"], ref["bias"] - before["bias"]])
        cos = float(move @ move_j / (move.norm() * move_j.norm()))
        assert cos > 0.999, (level, cos)
        pad = torch.cat([masks.weight_mask, masks.bias_mask]) == 0
        assert not torch.cat([got["weight"], got["bias"]])[pad].any(), level


# ---- the scene CLI on two ranks --------------------------------------------

N_FRAMES, SPLIT, HS, WS = 8, 4, 12, 16


def _tiny_replica(root):
    for sub in ("rgb", "depth", "semantic_class"):
        (root / sub).mkdir(parents=True)
    traj = []
    for i in range(N_FRAMES):
        rgb = np.zeros((HS, WS, 3), np.uint8)
        rgb[:, : WS // 2] = [180, 60, 40]
        rgb[:, WS // 2:] = [40, 120, 200]
        sem = np.zeros((HS, WS), np.uint8)
        sem[:, : WS // 2] = 3
        sem[:, WS // 2:] = 7 if i == 4 else 5  # train frames 0 and 4: one per rank
        imwrite(str(root / "rgb" / f"rgb_{i}.png"), rgb)
        imwrite(str(root / "depth" / f"depth_{i}.png"), np.full((HS, WS), 2500, np.uint16))
        imwrite(str(root / "semantic_class" / f"semantic_class_{i}.png"), sem)
        pose = np.eye(4)
        pose[2, 3] = -3.0 - 0.05 * i
        traj.append(pose.reshape(-1))
    np.savetxt(str(root / "traj_w_c.txt"), np.stack(traj), delimiter=" ")


def _cli_cfg(tmp, data, save_dir, name):
    """The tiny scene config at ``tmp/{name}.yaml`` saving to ``save_dir``."""
    from tests.test_torch_scene_trainer import _cfg_dict

    d = _cfg_dict(data, save_dir, n_iters=8, step_log_tfb=4, step_save_ckpt=4, step_val=8,
                  step_vis_train=4)
    d["render"]["N_rays"] = 8
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.dump(d))
    return str(path)


def _cli(tmp, name, cfg_path):
    spec = {"argv": ["--config_file", cfg_path, "--device", "cpu", "--total_frames",
                     str(N_FRAMES), "--split_step", str(SPLIT), "--seed", "2"], "n_iters": 8}
    torch.save(spec, tmp / f"{name}.pt")
    return spawn_ranks("cli", 2, str(tmp / f"{name}.pt"), str(tmp))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mh_cli")
    data = tmp / "room"
    _tiny_replica(data)
    # the uninterrupted run, each rank told to write to a directory of its own
    for r in range(2):
        _cli_cfg(tmp, data, tmp / f"run_rank{r}", f"full_rank{r}")
    full = _cli(tmp, "full", str(tmp / "full_rank{rank}.yaml"))
    # the resume: rank 0's files up to step 4, both ranks reading them
    cut = tmp / "cut"
    shutil.copytree(tmp / "run_rank0", cut)
    os.remove(cut / "checkpoints" / "000008.ckpt")
    shutil.rmtree(cut / "train_render" / "step_000008")
    resumed = _cli(tmp, "resumed", _cli_cfg(tmp, data, cut, "resumed"))
    return tmp, full, resumed


def test_cli_ranks_write_from_rank0_and_agree(cli_runs):
    tmp, (a, b), _ = cli_runs
    assert (a["lead"], b["lead"], a["logger"], b["logger"]) == (True, False, "TBLogger",
                                                                 "NullLogger")
    assert not (tmp / "run_rank1").exists(), "rank 1 wrote files"
    run = tmp / "run_rank0"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["000004.ckpt", "000008.ckpt"]
    for step in ("step_000004", "step_000008"):
        assert (run / "train_render" / step / "cluster" / "clusters.json").exists()
        assert (run / "train_render" / step / "rgb_000.png").exists()
    assert (run / "test_render" / "step_000008" / "rgb_000.png").exists()
    ck = torch.load(run / "checkpoints" / "000008.ckpt", weights_only=False)
    assert torch.equal(ck["generator_states"][1], b["generator"])
    assert torch.equal(ck["generator_state"], a["generator"])
    assert not torch.equal(a["generator"], b["generator"])  # each rank its own draws
    assert a["step"] == b["step"] == 8 and a["pool_images"] == b["pool_images"] == 1
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    assert all(torch.equal(x, y) for x, y in zip(a["table"], b["table"])) and bool(a["table"][3].any())
    assert a["anneal"] == b["anneal"]
    # rank 1 loads ids 3 and 7 only, rank 0 (with the test frames) 3 and 5:
    # the agreed set {3, 5, 7} gives both the same head (the first id is void)
    assert a["classes"] == b["classes"] == 2


def test_cli_two_rank_resume_is_exact(cli_runs):
    _, full, resumed = cli_runs
    for f, r in zip(full, resumed):
        assert r["start"] == 4 and r["step"] == 8
        assert all(torch.equal(x, y) for x, y in zip(f["params"], r["params"]))
        assert f["adam"].keys() == r["adam"].keys()
        for k in f["adam"]:
            assert all(torch.equal(f["adam"][k][n], r["adam"][k][n]) for n in f["adam"][k])
        assert all(torch.equal(x, y) for x, y in zip(f["table"], r["table"]))
        assert torch.equal(f["generator"], r["generator"]) and f["anneal"] == r["anneal"]


def test_cli_resume_needs_a_shared_save_dir(cli_runs):
    """Rank 0 finds the resumed run's checkpoints and rank 1, told to read a
    directory of its own, finds none: rank 1 raises instead of training on
    with an empty cluster table and a fresh generator."""
    tmp, _, _ = cli_runs
    data = tmp / "room"
    own = tmp / "own"
    shutil.copytree(tmp / "cut", own / "rank0")
    (own / "rank1").mkdir()
    for r in range(2):
        _cli_cfg(tmp, data, own / f"rank{r}", f"own_rank{r}")
    spec = {"argv": ["--config_file", str(tmp / "own_rank{rank}.yaml"), "--device", "cpu",
                     "--total_frames", str(N_FRAMES), "--split_step", str(SPLIT), "--seed", "2"],
            "n_iters": 8}
    torch.save(spec, tmp / "own.pt")
    with pytest.raises(AssertionError, match="rank 1 restored step None .* rank 0 step 8: "
                                             "resuming needs a save_dir that every rank reads"):
        spawn_ranks("cli", 2, str(tmp / "own.pt"), str(tmp), timeout=60)
