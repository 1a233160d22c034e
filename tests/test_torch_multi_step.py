"""K training steps per call, against the JAX package (CPU).

- ``Trainer._steps_per_call``: the JAX rule and the port's on the same
  stub trainer, case for case over a grid of K, cadences, start step,
  step count and ``--profile``; the value and the printed message equal.
- The schedules at a device step counter (0-dim int tensors) against the
  JAX schedules under ``jax.jit`` in float32: exact.
- ``make_multi_step(step, 4)`` on the CPU against the JAX
  ``make_multi_step(base, 4)`` for two calls (8 steps), the JAX step
  drawing from its key and the port's step handed the same draws through
  its hooks (as ``tests/test_torch_shared_draws.py`` does), with the LR
  decaying fast and both loss-weight switches inside the run, so a step
  that read a stale count would part from JAX.  Bound, that file's for
  ten steps: the loss terms of the last report within 1e-4 of their
  size, every parameter within 1e-4 of its level's largest.  And on the
  port alone, 4 steps per call equal 4 calls of one step, bitwise.
- ``Trainer.fit`` with ``steps_per_call`` 4 strides by blocks, calls its
  hook and logs on the cadence, and trains what 1 step per call trains,
  bitwise; with 3, which divides no cadence, it falls back to 1.
- A checkpoint keeps a number LR and restores the device step counter;
  ``tools/bench.py``'s workload and windows run at a tiny size.
"""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsicnerf_tpu.cluster import assign as ja
from intrinsicnerf_tpu.core.rays import create_rays as j_create_rays
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu.train import schedules as jsch
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu.train.trainer import Trainer as JTrainer
from intrinsicnerf_tpu_torch import config as tconfig
from intrinsicnerf_tpu_torch.cluster import assign as ta
from intrinsicnerf_tpu_torch.data import samplers as tsamp
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax, params_to_jax
from intrinsicnerf_tpu_torch.train import schedules as tsch
from intrinsicnerf_tpu_torch.train import step as tstep
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, Trainer

NC, NI, PAIRS, H, W, N_IMG, K = 6, 6, 8, 8, 12, 3, 4
MLP_KW = dict(depth=3, width=32, skips=(1,), n_freqs_pos=4, n_freqs_dir=2,
              pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=4)
# the LR decays by 10x every 10 steps; the residual weight switches after
# step 3, the intensity weight after step 5
TRAIN_KW = dict(n_rays=PAIRS, lrate_decay=10.0, residual_switch=3, intensity_switch=5)


# ---- the rule for K ---------------------------------------------------

CADENCES = [(4, 8, 16, 32), (10, 50, 200, 400), (6, 12, 24, 48), (8, 1000, 10_000, 50_000)]


def _stub(k, profile, cadences):
    log = types.SimpleNamespace(step_log_tfb=cadences[0], step_save_ckpt=cadences[1],
                                step_vis_train=cadences[2], step_val=cadences[3])
    train = types.SimpleNamespace(steps_per_call=k)
    return types.SimpleNamespace(cfg=types.SimpleNamespace(train=train, logging=log),
                                 profile_steps=profile)


@pytest.mark.parametrize("profile", [0, 3], ids=["plain", "profile"])
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 8, 10])
def test_steps_per_call_rule_matches_jax(k, profile, capsys):
    got_values = set()
    for cadences in CADENCES:
        for start in (0, 2, 8, 40, 48, 400):
            for n_iters in (start + 8, start + 40, start + 50, 400, 450, 1200):
                if n_iters <= start:
                    continue
                stub = _stub(k, profile, cadences)
                want = JTrainer._steps_per_call(stub, n_iters, start)
                said_jax = capsys.readouterr().out
                got = Trainer._steps_per_call(stub, n_iters, start)
                said_port = capsys.readouterr().out
                assert (got, said_port) == (want, said_jax), (k, profile, cadences, start, n_iters)
                got_values.add(got)
    if profile or k <= 1:
        assert got_values == {1}
    else:  # the grid reaches K, and every fallback is to 1
        assert k in got_values and got_values <= {k, 1}


# ---- the schedules at a device step counter ---------------------------

@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("step", [0, 1, 50_000, 50_001, 100_000, 100_001, 199_999])
def test_device_schedules_exact(step, dtype):
    args = (1.0, 0.02, 0.1, 0.01)
    step_j = jnp.int32(step)
    lr_j = np.asarray(jax.jit(jsch.make_lr_schedule(5e-4, 250e3))(step_j))
    w_j = jax.jit(lambda s: jsch.loss_weight_schedule(s, *args))(step_j)
    step_t = torch.tensor(step, dtype=dtype)
    lr_t = tsch.make_lr_schedule(5e-4, 250e3)(step_t)
    w_t = tsch.loss_weight_schedule(step_t, *args)
    for t, j in ((lr_t, lr_j), *zip(w_t, w_j)):
        assert t.dtype == torch.float32 and t.dim() == 0
        assert t.numpy() == np.asarray(j, np.float32), (step, float(t), float(j))


# ---- K steps per call against the JAX package ------------------------

def _jax_draws(key, step):
    """The draws the JAX step makes at ``step``, as port tensors."""
    k_sample, k_render = jax.random.split(jax.random.fold_in(key, step))
    k_img, k_pix, k_bh, k_bw = jax.random.split(k_sample, 4)
    pair = (jax.random.randint(k_img, (), 0, N_IMG),
            jax.random.randint(k_pix, (PAIRS,), 0, H * W),
            jax.random.randint(k_bh, (PAIRS,), -1, 2), jax.random.randint(k_bw, (PAIRS,), -1, 2))
    k_perturb, k_noise_c, k_pdf, k_noise_f = jax.random.split(k_render, 4)
    n = 2 * PAIRS
    e = -jnp.log1p(-jax.random.uniform(k_pdf, (n, NI + 1)))
    c = jnp.cumsum(e, axis=-1)
    noise = {"t_rand": jax.random.uniform(k_perturb, (n, NC)),
             "noise_c": jax.random.normal(k_noise_c, (n, NC)),
             "u": c[:, :-1] / c[:, -1:],
             "noise_f": jax.random.normal(k_noise_f, (n, NC + NI))}

    def t(a):
        return torch.from_numpy(np.array(a))

    return tuple(t(x).long() for x in pair), {k: t(v) for k, v in noise.items()}


def _scene(rng):
    c2w = np.tile(np.eye(4, dtype=np.float32), (N_IMG, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(N_IMG, 3)) * 0.3 + [0, 0, -2.5]
    rays = np.array(j_create_rays(jnp.asarray(c2w), H, W, 6.0, 6.0, (W - 1) / 2, (H - 1) / 2,
                                  0.5, 5.0))
    rgb = rng.uniform(0.05, 0.95, size=(N_IMG, H * W, 3)).astype(np.float32)
    sem = rng.integers(0, 5, size=(N_IMG, H * W)).astype(np.int32)
    per = [(rng.uniform(0.1, 0.5, size=(16, 3)).astype(np.float32), rng.integers(0, 3, 16),
            rng.uniform(0.1, 0.9, size=(3, 3)).astype(np.float32)) for _ in range(4)]
    return rays, rgb, sem, per


def _port_pools(rays, rgb, sem):
    return tstep.DataPools(rays=torch.from_numpy(rays), rgb=torch.from_numpy(rgb), depth=None,
                           semantic=torch.from_numpy(sem).long(),
                           mask_ids=torch.ones(N_IMG, dtype=torch.long))


def test_multi_step_matches_jax_multi_step():
    rng = np.random.default_rng(0)
    rays, rgb, sem, per = _scene(rng)
    jcfg, tcfg = jm.MLPConfig(**MLP_KW), tm.MLPConfig(**MLP_KW)
    render = dict(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0)
    tj, tt = jstep.TrainConfig(**TRAIN_KW), tstep.TrainConfig(**TRAIN_KW)
    opt = optax.adam(jsch.make_lr_schedule(tj.lrate, tj.lrate_decay))
    state_j = jstep.create_train_state(jax.random.key(3), jcfg, tj, opt)

    def lift(p):  # sigma above zero, so both levels render from the start
        return {**p, "sigma": {**p["sigma"], "bias": p["sigma"]["bias"] + 2.0}}

    params = {"coarse": lift(state_j.params_coarse), "fine": lift(state_j.params_fine)}
    state_j = state_j._replace(params_coarse=params["coarse"], params_fine=params["fine"],
                               opt_state=opt.init(params))
    jpools = jstep.DataPools(rays=jnp.asarray(rays), rgb=jnp.asarray(rgb), depth=None,
                             semantic=jnp.asarray(sem), mask_ids=jnp.ones(N_IMG, jnp.int32))
    base_j = jstep.make_train_step(jcfg, jp.RenderConfig(**render), tj, opt, H, W)
    multi_j = jax.jit(jstep.make_multi_step(base_j, K))

    state_t = tstep.create_train_state(tcfg, tt, device="cpu")
    for m, p in ((state_t.model_coarse, params["coarse"]), (state_t.model_fine, params["fine"])):
        m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu"))
    key, current = jax.random.key(7), {}

    def sample_fn(generator, pools, step):
        pair, current["noise"] = _jax_draws(key, step)
        return tsamp.gather_ray_pairs(pools.rays, pools.rgb, H, W, *pair,
                                      sem_pool=pools.semantic, mask_ids=pools.mask_ids)

    base_t = tstep.make_train_step(tcfg, tp.RenderConfig(**render), tt, H, W, sample_fn=sample_fn,
                                   noise_fn=lambda generator, n: current["noise"])
    multi_t = tstep.make_multi_step(base_t, K)
    table_j, table_t = ja.table_from_numpy(per, 32), ta.table_from_numpy(per, 32, device="cpu")
    tpools = _port_pools(rays, rgb, sem)
    for call in range(2):
        state_j, rep_j = multi_j(state_j, jpools, table_j, jnp.float32(0.5), key)
        rep_t = multi_t(state_t, tpools, table_t, torch.tensor(0.5), None)
        assert state_t.step == int(state_t.step_t) == int(state_j.step) == K * (call + 1)
    assert float(rep_t.reflect_cluster) > 0 and float(rep_t.intensity) > 0
    for name in rep_j._fields:
        a, b = float(getattr(rep_t, name)), float(getattr(rep_j, name))
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6), (name, a, b)
    for model, pj in ((state_t.model_coarse, state_j.params_coarse),
                      (state_t.model_fine, state_j.params_fine)):
        got = jax.tree_util.tree_leaves(params_to_jax(model))
        ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, pj))
        scale = max(np.abs(b).max() for b in ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)


def test_multi_step_equals_single_steps_on_host():
    """One call of 4 steps and 4 calls of one step, from the same state
    and generator, are the same arithmetic: bitwise equal parameters,
    Adam state, reports and generator state."""
    rng = np.random.default_rng(1)
    rays, rgb, sem, per = _scene(rng)
    tcfg = tm.MLPConfig(**MLP_KW)
    tt = tstep.TrainConfig(**TRAIN_KW)
    rcfg = tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0)
    pools, table = _port_pools(rays, rgb, sem), ta.table_from_numpy(per, 32, device="cpu")
    step = tstep.make_train_step(tcfg, rcfg, tt, H, W)
    runs = []
    for multi in (False, True):
        state = tstep.create_train_state(tcfg, tt, device="cpu",
                                         generator=torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(5)
        if multi:
            rep = tstep.make_multi_step(step, K)(state, pools, table, torch.tensor(0.5), gen)
        else:
            for _ in range(K):
                rep = step(state, pools, table, torch.tensor(0.5), gen)
        runs.append((state, rep, gen.get_state()))
    (s1, r1, g1), (s2, r2, g2) = runs
    assert s1.step == s2.step == int(s2.step_t) == K
    assert torch.equal(g1, g2)
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    for a, b in zip(s1.optimizer.param_groups[0]["params"], s2.optimizer.param_groups[0]["params"]):
        assert torch.equal(a, b)
        sa, sb = s1.optimizer.state[a], s2.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_multi_step_rejects_zero_steps():
    with pytest.raises(ValueError, match="steps per call"):
        tstep.make_multi_step(lambda *a: None, 0)


# ---- the trainer's loop -----------------------------------------------

def _fit(tmp_path, spc, name):
    rng = np.random.default_rng(2)
    rays, rgb, sem, _ = _scene(rng)
    pools = _port_pools(rays, rgb, sem)
    bundle = SceneBundle(pools=pools, rays_vis=pools.rays[:1], rays_test=pools.rays[:1],
                         h=H, w=W, h_scaled=H, w_scaled=W, num_valid_classes=4)
    cfg = tconfig.FrameworkConfig(
        experiment=tconfig.ExperimentConfig(save_dir=str(tmp_path / name)),
        mlp=tm.MLPConfig(**MLP_KW),
        render=tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0),
        train=tstep.TrainConfig(n_rays=PAIRS, n_iters=8, steps_per_call=spc),
        logging=tconfig.LoggingConfig(step_log_tfb=4, step_save_ckpt=10**9,
                                      step_vis_train=10**9, step_val=10**9))
    trainer = Trainer(cfg, bundle, seed=0, device="cpu")
    calls = []
    trainer.step_hook = lambda done, t0, t1, did_work: calls.append((done, did_work))
    k = trainer._steps_per_call(8, 0)
    report = trainer.fit(n_iters=8, progress=False)
    trainer.close()
    with open(os.path.join(cfg.experiment.save_dir, "tfb_logs", "scalars.csv")) as f:
        logged = sorted({int(row[0]) for row in csv.reader(f) if row[1] == "Train/Loss/total"})
    params = [p.detach().clone() for m in (trainer.state.model_coarse, trainer.state.model_fine)
              for p in m.parameters()]
    return k, calls, logged, report, trainer, params


def test_trainer_fit_strides_by_steps_per_call(tmp_path):
    k, calls, logged, report, trainer, params = _fit(tmp_path, 4, "spc4")
    assert k == 4 and trainer.multi_step.k == 4
    assert calls == [(4, True), (8, True)]
    assert logged == [4, 8]
    assert trainer.global_step == trainer.state.step == int(trainer.state.step_t) == 8
    assert np.isfinite(float(report.total))

    k1, calls1, logged1, report1, _, params1 = _fit(tmp_path, 1, "spc1")
    assert k1 == 1 and [c[0] for c in calls1] == list(range(1, 9)) and logged1 == [4, 8]
    assert all(torch.equal(a, b) for a, b in zip(params, params1))
    assert torch.equal(report.total, report1.total)


def test_trainer_fit_falls_back_when_k_divides_no_cadence(tmp_path, capsys):
    k, calls, logged, _, trainer, _ = _fit(tmp_path, 3, "spc3")
    assert "steps_per_call=3 does not divide" in capsys.readouterr().out
    assert k == 1 and trainer.multi_step is None
    assert [c[0] for c in calls] == list(range(1, 9)) and logged == [4, 8]


def test_trainer_fit_logs_each_step_from_its_own_report(tmp_path):
    """A log's row is written after the next step is enqueued; it holds
    the terms of its own step although the step function returns the same
    buffers every call, as a graph replay does."""
    rng = np.random.default_rng(2)
    rays, rgb, sem, _ = _scene(rng)
    pools = _port_pools(rays, rgb, sem)
    bundle = SceneBundle(pools=pools, rays_vis=pools.rays[:1], rays_test=pools.rays[:1],
                         h=H, w=W, h_scaled=H, w_scaled=W, num_valid_classes=4)
    cfg = tconfig.FrameworkConfig(
        experiment=tconfig.ExperimentConfig(save_dir=str(tmp_path / "log")),
        mlp=tm.MLPConfig(**MLP_KW),
        render=tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0),
        train=tstep.TrainConfig(n_rays=PAIRS, n_iters=6, steps_per_call=1),
        logging=tconfig.LoggingConfig(step_log_tfb=2, step_save_ckpt=10**9,
                                      step_vis_train=10**9, step_val=10**9))
    trainer = Trainer(cfg, bundle, seed=0, device="cpu")
    step, held, seen = trainer.step_fn, None, {}

    def fixed_buffers(*args):
        nonlocal held
        rep = step(*args)
        if held is None:
            held = type(rep)(*(v.detach().clone() for v in rep))
        for buf, v in zip(held, rep):
            buf.copy_(v)
        seen[int(args[0].step)] = float(rep.total)
        return held

    trainer.step_fn = fixed_buffers
    trainer.fit(n_iters=6, progress=False)
    trainer.close()
    with open(os.path.join(cfg.experiment.save_dir, "tfb_logs", "scalars.csv")) as f:
        logged = {int(row[0]): float(row[2]) for row in csv.reader(f)
                  if row[1] == "Train/Loss/total"}
    assert sorted(logged) == [2, 4, 6]
    assert logged == {s: seen[s] for s in logged}
    assert len(set(seen.values())) == 6


def test_checkpoint_keeps_a_number_lr_and_restores_the_counter(tmp_path):
    """The graphed step leaves a device tensor as Adam's LR; the checkpoint
    keeps a number (the ``.ckpt`` layout), and a restore sets the device
    step counter with the host's."""
    from intrinsicnerf_tpu_torch.train.checkpoint import Checkpointer, snapshot

    rng = np.random.default_rng(3)
    rays, rgb, sem, per = _scene(rng)
    tcfg, tt = tm.MLPConfig(**MLP_KW), tstep.TrainConfig(**TRAIN_KW)
    rcfg = tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0)
    pools, table = _port_pools(rays, rgb, sem), ta.table_from_numpy(per, 32, device="cpu")
    step = tstep.make_train_step(tcfg, rcfg, tt, H, W)
    state = tstep.create_train_state(tcfg, tt, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for _ in range(3):
        step(state, pools, table, torch.tensor(0.5), gen)
    for group in state.optimizer.param_groups:
        group["lr"] = torch.tensor(group["lr"])
    assert all(isinstance(g["lr"], float)
               for g in snapshot(state, gen)["optimizer_state_dict"]["param_groups"])
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(state, 3, gen)
    fresh = tstep.create_train_state(tcfg, tt, device="cpu")
    gen2 = torch.Generator()
    assert ck.restore(fresh, generator=gen2) == 3
    ck.close()
    assert fresh.step == int(fresh.step_t) == 3
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert all(torch.equal(a, b) for a, b in zip(fresh.model_fine.parameters(),
                                                 state.model_fine.parameters()))


def test_bench_measures_on_the_host_at_a_tiny_size():
    """``tools/bench.py``'s workload and windows at a tiny size on the CPU:
    the JSON fields, finite rates, K steps per call and the windows'
    steps all taken."""
    from intrinsicnerf_tpu_torch.tools import bench

    mcfg = tm.MLPConfig(**MLP_KW)
    rcfg = tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0)
    workload = bench.make_workload("cpu", seed=1, mcfg=mcfg, rcfg=rcfg,
                                   tcfg=tstep.TrainConfig(n_rays=PAIRS), h=H, w=W, n_img=N_IMG)
    state = workload[1]
    assert bool(workload[3].has_cluster.all())  # a live table: every class clustered
    result = bench.measure(*workload, rays_per_step=2 * PAIRS, steps_per_call=2, windows=2,
                           steps_per_window=4, warmup=1)
    assert state.step == 2 + 2 * 4
    assert result["metric"] == "train_rays_per_s_per_chip" and result["steps_per_call"] == 2
    assert set(result["spread"]) == {"windows", "steps_per_window", "min", "max", "iqr"}
    assert np.isfinite(result["value"]) and result["value"] > 0
    assert result["ms_per_step"] == pytest.approx(1e3 * 2 * PAIRS / result["value"])
    assert bench.device_info("cpu") == {"name": "cpu", "power_limit": None}
    with pytest.raises(ValueError, match="must divide"):
        bench.measure(*workload, rays_per_step=2 * PAIRS, steps_per_call=3, steps_per_window=4)
