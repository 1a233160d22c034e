"""Ten training steps with every random draw shared: the port's step and
the JAX step stay together.

The single-step tests (``test_torch_train.py``) run without draws
(``perturb`` 0, no sigma noise).  Here the JAX step draws from its key as
it does in training (``fold_in(key, step)``, then the pair sampler, the
stratified jitter, the sigma noise and the sorted importance uniforms),
the same numbers are computed from the same keys and injected into the
port's step through its ``sample_fn`` / ``noise_fn`` hooks, and both run
ten steps of Adam with the decayed learning rate, with and without the
intrinsic priors, at a small unfused fp32 width.

Bound: every parameter within 1e-4 of its size after ten steps.  The two
sides sum in different orders (fp32, ~1e-7 per step), and the
differences grow through the steps (measured 1.3e-5 at step 10 and 4e-3
at step 100 with the priors off).  Past that the parameters drift apart
while the loss terms stay together, so the 200-step run without priors
holds the loss terms of every step.
"""

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
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu.train.schedules import make_lr_schedule
from intrinsicnerf_tpu_torch.cluster import assign as ta
from intrinsicnerf_tpu_torch.data import samplers as tsamp
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax, params_to_jax
from intrinsicnerf_tpu_torch.train import step as tstep

NC, NI, PAIRS, H, W, N_IMG, STEPS = 16, 16, 32, 8, 12, 3, 10
NO_PRIORS = dict(no_intrinsic_loss=True, no_cluster=True)
LONG_STEPS = 200


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


def _both_steps(ablation):
    """The JAX step and the port's step from the same weights, on the same
    data, the port's drawing what the JAX step draws: ``advance()`` runs
    one step of each and returns both reports."""
    rng = np.random.default_rng(0)
    kw = dict(depth=4, width=32, skips=(2,), n_freqs_pos=6, n_freqs_dir=3,
              pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=4)
    jcfg, tcfg = jm.MLPConfig(**kw), tm.MLPConfig(**kw)
    rj = jp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0)
    rt = tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0)
    tj, tt = jstep.TrainConfig(n_rays=PAIRS, **ablation), tstep.TrainConfig(n_rays=PAIRS, **ablation)
    c2w = np.tile(np.eye(4, dtype=np.float32), (N_IMG, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(N_IMG, 3)) * 0.3 + [0, 0, -2.5]
    rays = np.array(j_create_rays(jnp.asarray(c2w), H, W, 6.0, 6.0, (W - 1) / 2, (H - 1) / 2,
                                  0.5, 5.0))
    rgb = rng.uniform(0.05, 0.95, size=(N_IMG, H * W, 3)).astype(np.float32)
    sem = rng.integers(0, 5, size=(N_IMG, H * W)).astype(np.int32)
    ones = np.ones(N_IMG, np.int32)
    jpools = jstep.DataPools(rays=jnp.asarray(rays), rgb=jnp.asarray(rgb), depth=None,
                             semantic=jnp.asarray(sem), mask_ids=jnp.asarray(ones))
    tpools = tstep.DataPools(rays=torch.from_numpy(rays), rgb=torch.from_numpy(rgb), depth=None,
                             semantic=torch.from_numpy(sem).long(),
                             mask_ids=torch.from_numpy(ones).long())
    per = [(rng.uniform(0.1, 0.5, size=(16, 3)).astype(np.float32), rng.integers(0, 3, 16),
            rng.uniform(0.1, 0.9, size=(3, 3)).astype(np.float32)) for _ in range(4)]
    table_j, table_t = ja.table_from_numpy(per, 32), ta.table_from_numpy(per, 32, device="cpu")

    opt = optax.adam(make_lr_schedule(tj.lrate, tj.lrate_decay))
    state_j = jstep.create_train_state(jax.random.key(3), jcfg, tj, opt)

    def lift(p):  # sigma above zero, so both levels render from the start
        return {**p, "sigma": {**p["sigma"], "bias": p["sigma"]["bias"] + 2.0}}

    params = {"coarse": lift(state_j.params_coarse), "fine": lift(state_j.params_fine)}
    state_j = state_j._replace(params_coarse=params["coarse"], params_fine=params["fine"],
                               opt_state=opt.init(params))
    step_j = jax.jit(jstep.make_train_step(jcfg, rj, tj, opt, H, W))
    state_t = tstep.create_train_state(tcfg, tt, device="cpu")
    for m, p in ((state_t.model_coarse, params["coarse"]), (state_t.model_fine, params["fine"])):
        m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu"))

    key, current = jax.random.key(7), {}

    def sample_fn(generator, pools, step):
        pair, current["noise"] = _jax_draws(key, step)
        return tsamp.gather_ray_pairs(pools.rays, pools.rgb, H, W, *pair,
                                      sem_pool=pools.semantic, mask_ids=pools.mask_ids)

    step_t = tstep.make_train_step(tcfg, rt, tt, H, W, sample_fn=sample_fn,
                                   noise_fn=lambda generator, n: current["noise"])
    state = {"j": state_j}

    def advance():
        state["j"], rep_j = step_j(state["j"], jpools, table_j, jnp.float32(0.5), key)
        return step_t(state_t, tpools, table_t, 0.5, None), rep_j

    return advance, state, state_t


@pytest.mark.parametrize("ablation", [{}, NO_PRIORS], ids=["all_losses", "no_priors"])
def test_steps_with_shared_draws_track_jax(ablation):
    advance, state, state_t = _both_steps(ablation)
    for _ in range(STEPS):
        rep_t, rep_j = advance()
    state_j = state["j"]
    assert state_t.step == int(state_j.step) == STEPS
    assert abs(float(rep_t.total) - float(rep_j.total)) <= 1e-4 * abs(float(rep_j.total))
    for model, pj in ((state_t.model_coarse, state_j.params_coarse),
                      (state_t.model_fine, state_j.params_fine)):
        got = jax.tree_util.tree_leaves(params_to_jax(model))
        ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, pj))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-6))


def test_no_prior_loss_terms_track_jax_for_200_steps():
    """The arm without priors, where nothing but the photometric and
    semantic losses shapes the albedo / shading / residual split: over
    200 steps every loss term, the unweighted prior terms that read that
    split among them, follows the JAX step's.  Bound: the largest
    difference over the run within 2e-3 of the term's largest value
    (measured 5.5e-4), and 2e-2 for the reflectance sparsity and far
    terms, whose values are 1e-7..1e-3 (measured 6.2e-3).  The
    parameters themselves drift apart by fp32 sum order (4e-3 of their
    size at step 100, 7e-2 at 200), the losses barely."""
    advance, _, _ = _both_steps(NO_PRIORS)
    names = ("total", "img_coarse", "img_fine", "semantic", "chroma", "residual",
             "reflect_sparsity", "far_reflect", "intensity")
    got, ref = {n: [] for n in names}, {n: [] for n in names}
    for _ in range(LONG_STEPS):
        rep_t, rep_j = advance()
        for n in names:
            got[n].append(float(getattr(rep_t, n)))
            ref[n].append(float(getattr(rep_j, n)))
    for n in names:
        a, b = np.array(got[n]), np.array(ref[n])
        tol = 2e-2 if n in ("reflect_sparsity", "far_reflect") else 2e-3
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), n
