"""The training slice of the PyTorch port against the JAX package (CPU).

Inputs are made with numpy from fixed seeds and handed to both packages;
the port's state is carried from the JAX state with ``params_from_jax``
(packed JAX state is unpacked with the JAX ``unpack_weights`` first).
Tolerances:

- compositing weights, losses, cluster assignment, sampler, schedules:
  atol 1e-6 or exact (the same fp32 elementwise arithmetic; the cluster
  tables and gathers are copies);
- Adam with the hand-set LR against ``optax.adam(make_lr_schedule)``:
  atol 1e-7 over 3 steps (the two round ``m / (sqrt(v) + eps)`` in
  another order);
- one whole training step from identical state and batch, perturb 0 and
  no sigma noise, so neither side draws:
  - fused at width 256 (JAX: Pallas in interpret mode; port: the kernels'
    plain versions), both on packed state: loss terms within 1e-3
    relative, per-level cosine > 0.999 between the masked packed
    gradients (the bf16 roundings agree, the fp32 sums do not), exactly
    zero on the padded slots in both;
  - unfused at width 32 in fp32: loss terms atol 1e-5, gradients
    rtol 1e-4 with an absolute floor of 1e-4 times the level's largest
    gradient (elements near zero carry summation-order noise of that
    size).  The importance samples are deterministic (``u`` = linspace);
    a fine sample moved by the ``denom < 1e-5`` switch of ``sample_pdf``
    would show as a fine loss term off by far more than 1e-5, and none
    is at these inputs, so no looser bound is needed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsicnerf_tpu.cluster import assign as ja
from intrinsicnerf_tpu.core import compositing as jc
from intrinsicnerf_tpu.core import losses as jl
from intrinsicnerf_tpu.core.rays import create_rays as j_create_rays
from intrinsicnerf_tpu.data import samplers as js
from intrinsicnerf_tpu.data.samplers import RayBatch as JBatch
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.ops import fused_mlp as jf
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu.train import schedules as jsch
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu_torch.cluster import assign as ta
from intrinsicnerf_tpu_torch.core import compositing as tc
from intrinsicnerf_tpu_torch.core import losses as tl
from intrinsicnerf_tpu_torch.core.sampling import sorted_uniforms
from intrinsicnerf_tpu_torch.data import samplers as tsamp
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.tools.import_ckpt import packed_from_jax, params_from_jax
from intrinsicnerf_tpu_torch.train import schedules as tsch
from intrinsicnerf_tpu_torch.train import step as tstep


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol, rtol=rtol)


# ---- compositing and sampling ----------------------------------------


def _alphas(rng, n=9, s=17):
    a = rng.uniform(0.0, 1.0, size=(n, s)).astype(np.float32)
    a[0, 5] = 1.0  # an opaque sample mid-ray
    a[1, :] = 1.0  # a fully opaque ray
    a[2, -1] = 1.0
    a[3] = 0.0
    return a


def test_alpha_to_weights_forward_and_grad_match_jax():
    rng = np.random.default_rng(0)
    alpha = _alphas(rng)
    gw = rng.normal(size=alpha.shape).astype(np.float32)
    w_j, vjp = jax.vjp(jc.alpha_to_weights, jnp.asarray(alpha))
    (ga_j,) = vjp(jnp.asarray(gw))
    a = _t(alpha).requires_grad_(True)
    w_t = tc.alpha_to_weights(a)
    w_t.backward(_t(gw))
    _close(w_j, w_t.detach(), 1e-6)
    _close(ga_j, a.grad, 1e-6)
    assert torch.isfinite(a.grad).all()


def test_alpha_to_weights_gradcheck_float64():
    rng = np.random.default_rng(1)
    alpha = torch.from_numpy(rng.uniform(0.05, 0.95, size=(4, 7))).requires_grad_(True)
    assert torch.autograd.gradcheck(tc.alpha_to_weights, (alpha,))


def test_sorted_uniforms():
    g = torch.Generator().manual_seed(3)
    u = sorted_uniforms((5000, 16), g)
    assert u.shape == (5000, 16) and u.dtype == torch.float32
    assert (u > 0).all() and (u < 1).all() and (torch.diff(u, dim=-1) >= 0).all()
    # order statistics of 16 uniforms: E[u_(k)] = k / 17
    np.testing.assert_allclose(u.mean(0).numpy(), np.arange(1, 17) / 17, atol=0.01)
    again = sorted_uniforms((5000, 16), torch.Generator().manual_seed(3))
    assert torch.equal(u, again)


@pytest.mark.parametrize("perturb,noise,n_imp", [(1.0, 1.0, 8), (0.0, 0.0, 8), (1.0, 0.0, 0)])
def test_draw_train_noise(perturb, noise, n_imp):
    rcfg = tp.RenderConfig(n_coarse=6, n_importance=n_imp, perturb=perturb, raw_noise_std=noise)
    d = tp.draw_train_noise(5, rcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(d) == {"t_rand", "noise_c", "u", "noise_f"}
    assert (d["t_rand"] is not None) == (perturb > 0)
    assert (d["noise_c"] is not None) == (noise > 0)
    assert (d["u"] is not None) == (perturb > 0 and n_imp > 0)
    assert (d["noise_f"] is not None) == (noise > 0 and n_imp > 0)
    shapes = {"t_rand": (5, 6), "noise_c": (5, 6), "u": (5, n_imp), "noise_f": (5, 6 + n_imp)}
    for k, v in d.items():
        if v is not None:
            assert tuple(v.shape) == shapes[k], k


# ---- losses ------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(4)
    n2 = 24
    f = lambda *s: rng.uniform(0.05, 1.0, size=s).astype(np.float32)  # noqa: E731
    labels = rng.integers(0, 2, size=n2)  # two classes: many same-label pairs, near and far
    return dict(albedo=f(n2, 3), shading=f(n2), residual=f(n2, 3), rgb=f(n2, 3),
                labels=labels, mask=(rng.uniform(size=n2) > 0.3).astype(np.float32))


def test_elementwise_losses_match_jax(loss_inputs):
    x = loss_inputs
    a, b = x["albedo"], x["rgb"]
    pairs = [
        (jl.img2mse(a, b), tl.img2mse(_t(a), _t(b))),
        (jl.chroma_loss(a, b), tl.chroma_loss(_t(a), _t(b))),
        (jl.residual_loss(x["residual"]), tl.residual_loss(_t(x["residual"]))),
        (jl.intensity_loss(b, a), tl.intensity_loss(_t(b), _t(a))),
        (jl.reflect_sparsity_loss(a, b, x["shading"]),
         tl.reflect_sparsity_loss(_t(a), _t(b), _t(x["shading"]))),
        (jl.shading_smooth_loss(x["shading"], x["mask"], x["shading"]),
         tl.shading_smooth_loss(_t(x["shading"]), _t(x["mask"]), _t(x["shading"]))),
    ]
    pairs += list(zip(jl.chromaticity(a), tl.chromaticity(_t(a))))
    pairs += list(zip(jl.chroma_pair_weights(a, b, x["mask"]),
                      tl.chroma_pair_weights(_t(a), _t(b), _t(x["mask"]))))
    pairs += list(zip(jl.chroma_pair_weights_masked(a, b, x["mask"], x["shading"]),
                      tl.chroma_pair_weights_masked(_t(a), _t(b), _t(x["mask"]),
                                                    _t(x["shading"]))))
    for i, (j, t) in enumerate(pairs):
        _close(j, t, 1e-6, 1e-6)
    mse = np.float32(0.0123)
    _close(jl.mse2psnr(jnp.asarray(mse)), tl.mse2psnr(torch.tensor(mse)), 0.0, 1e-6)


@pytest.mark.parametrize("mode", ["label", "mask"])
def test_compute_intrinsic_losses_match_jax(loss_inputs, mode):
    x = loss_inputs
    lab = x["labels"] if mode == "label" else x["mask"]
    j = jl.compute_intrinsic_losses(x["albedo"], x["shading"], x["residual"], x["rgb"],
                                    jnp.asarray(lab), mask_mode=mode)
    t = tl.compute_intrinsic_losses(_t(x["albedo"]), _t(x["shading"]), _t(x["residual"]),
                                    _t(x["rgb"]), torch.from_numpy(np.asarray(lab)),
                                    mask_mode=mode)
    assert t._fields == j._fields
    for name in j._fields:
        _close(getattr(j, name), getattr(t, name), 1e-6, 1e-6)
    assert float(t.far_reflect) > 0 and float(t.reflect_sparsity) > 0


def test_semantic_cross_entropy_and_void_only_batch():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(10, 4)).astype(np.float32) * 3
    labels = np.array([0, 1, 2, 3, 4, 0, 1, 1, 4, 2])
    _close(jl.semantic_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)),
           tl.semantic_cross_entropy(_t(logits), torch.from_numpy(labels)), 1e-6)
    void = np.zeros(10, np.int64)
    lt = _t(logits).requires_grad_(True)
    ce = tl.semantic_cross_entropy(lt, torch.from_numpy(void))
    assert float(ce.detach()) == 0.0 == float(jl.semantic_cross_entropy(jnp.asarray(logits),
                                                                jnp.asarray(void)))
    ce.backward()
    assert float(lt.grad.abs().max()) == 0.0
    ref = torch.nn.CrossEntropyLoss(ignore_index=-1)(_t(logits), torch.from_numpy(void) - 1)
    assert torch.isnan(ref)  # what a plain port would have returned


# ---- cluster assignment ------------------------------------------------


def _per_class(rng, c=4, a=64):
    per = []
    for i in range(c):
        if i == 1:
            per.append(None)  # a class without clusters
            continue
        k = 5
        centers = rng.uniform(0.05, 1.0, size=(k, 3)).astype(np.float32)
        m = a + 20 if i == 2 else a - 7  # class 2 is truncated
        links = rng.integers(0, k, size=m)
        anchors = np.asarray(ja.map_drgb(jnp.asarray(centers[links]))) + rng.normal(
            size=(m, 3)).astype(np.float32) * 0.02
        per.append((anchors, links, centers))
    return per


def test_cluster_table_and_assignment_match_jax(capsys):
    rng = np.random.default_rng(6)
    per = _per_class(rng)
    tj = ja.table_from_numpy(per, 64)
    tt = ta.table_from_numpy(per, 64, device="cpu")
    assert "class 2: truncating 84 anchors to 64" in capsys.readouterr().out
    for name in ("anchors", "colors", "links", "has_cluster"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(tj, name)))
    assert tt.intensity_factor == float(tj.intensity_factor)
    rgb = rng.uniform(0.05, 1.0, size=(200, 3)).astype(np.float32)
    lab = rng.integers(0, 5, size=200)  # 4 is out of range: clamped, as in JAX
    np.testing.assert_array_equal(
        ta.dest_color(tt, _t(rgb), torch.from_numpy(lab)).numpy(),
        np.asarray(ja.dest_color(tj, jnp.asarray(rgb), jnp.asarray(lab))))
    np.testing.assert_array_equal(
        ta.dest_class(tt, _t(rgb), torch.from_numpy(lab)).numpy(),
        np.asarray(ja.dest_class(tj, jnp.asarray(rgb), jnp.asarray(lab))))
    _close(ja.map_drgb(jnp.asarray(rgb)), ta.map_drgb(_t(rgb)), 1e-6)
    _close(ja.inv_map_drgb(ja.map_drgb(jnp.asarray(rgb))),
           ta.inv_map_drgb(ta.map_drgb(_t(rgb))), 1e-6)
    empty = ta.empty_cluster_table(5, 8, device="cpu")
    assert torch.equal(ta.dest_color(empty, _t(rgb), torch.from_numpy(lab)), _t(rgb))
    assert (ta.dest_class(empty, _t(rgb), torch.from_numpy(lab)) == -1).all()


# ---- sampler and schedules ---------------------------------------------

H = W = 6


def _pools(rng, n_img=3, classes=4):
    c2w = np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(n_img, 3)) * 0.3
    c2w[:, 2, 3] -= 3.0
    rays = np.asarray(j_create_rays(jnp.asarray(c2w), H, W, 5.0, 5.0, 2.5, 2.5, 1.0, 6.0))
    return dict(rays=rays, rgb=rng.uniform(size=(n_img, H * W, 3)).astype(np.float32),
                depth=rng.uniform(1, 5, size=(n_img, H * W)).astype(np.float32),
                semantic=rng.integers(0, classes + 1, size=(n_img, H * W)).astype(np.int32),
                mask_ids=np.array([1, 0, 1], np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_same_indices_same_batch(seed):
    pools = _pools(np.random.default_rng(10))
    n = 40
    key = jax.random.key(seed)
    bj = js.sample_ray_pairs(key, *(jnp.asarray(pools[k]) for k in ("rays", "rgb")), H, W, n,
                             depth_pool=jnp.asarray(pools["depth"]),
                             sem_pool=jnp.asarray(pools["semantic"]),
                             mask_ids=jnp.asarray(pools["mask_ids"]))
    k_img, k_pix, k_bh, k_bw = jax.random.split(key, 4)
    draws = (jax.random.randint(k_img, (), 0, 3), jax.random.randint(k_pix, (n,), 0, H * W),
             jax.random.randint(k_bh, (n,), -1, 2), jax.random.randint(k_bw, (n,), -1, 2))
    draws = [torch.from_numpy(np.array(x, np.int64)) for x in draws]
    bt = tsamp.gather_ray_pairs(_t(pools["rays"]), _t(pools["rgb"]), H, W, *draws,
                                depth_pool=_t(pools["depth"]),
                                sem_pool=torch.from_numpy(pools["semantic"]),
                                mask_ids=torch.from_numpy(pools["mask_ids"]))
    for name in ("rays", "rgb", "depth", "semantic", "sem_flag", "image_idx"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)),
                                      err_msg=name)


def test_sampler_pairing_contract():
    pools = _pools(np.random.default_rng(11))
    n = 64
    b = tsamp.sample_ray_pairs(torch.Generator().manual_seed(0), _t(pools["rays"]),
                               _t(pools["rgb"]), H, W, n, sem_pool=torch.from_numpy(
                                   pools["semantic"]))
    assert b.rays.shape == (2 * n, 11) and b.semantic.shape == (2 * n,)
    assert float(b.sem_flag) == 1.0
    pool = pools["rays"][int(b.image_idx)]
    idx = np.argmin(np.linalg.norm(pool[None, :, 3:6] - b.rays[:, None, 3:6].numpy(), axis=-1),
                    axis=1)
    r, c = idx // W, idx % W
    assert np.all(np.abs(r[:n] - r[n:]) <= 1) and np.all(np.abs(c[:n] - c[n:]) <= 1)
    np.testing.assert_array_equal(b.rgb.numpy(), pools["rgb"][int(b.image_idx)][idx])


@pytest.mark.parametrize("step", [0, 1, 50_000, 50_001, 100_000, 100_001, 250_000])
def test_schedules_exact(step):
    args = (1.0, 0.02, 0.1, 0.01)
    wj = [float(x) for x in jsch.loss_weight_schedule(jnp.asarray(step), *args)]
    wt = tsch.loss_weight_schedule(step, *args)
    assert [float(np.float32(x)) for x in wt] == wj
    lr_j = float(jsch.make_lr_schedule(5e-4, 250e3)(step))
    assert tsch.make_lr_schedule(5e-4, 250e3)(step) == pytest.approx(lr_j, rel=1e-6)
    assert tsch.cluster_anneal(step + 10_000, 10_000, 200_000) == jsch.cluster_anneal(
        step + 10_000, 10_000, 200_000)


def test_adam_with_hand_set_lr_matches_optax():
    """The port sets Adam's lr from the schedule at the pre-update count;
    optax reads ``exponential_decay`` there too.  Reading it one step
    late (as a torch LR scheduler would) visibly differs."""
    rng = np.random.default_rng(12)
    # weights at an MLP's scale (|w| <= 1/sqrt(fan_in)), where 1e-7 is a few ulp
    p0 = {"a": rng.uniform(-0.1, 0.1, size=(5, 3)).astype(np.float32),
          "b": rng.uniform(-0.1, 0.1, size=7).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    sched_args = (5e-4, 10.0)  # the scene LR with a fast decay, so the step index matters
    opt = optax.adam(jsch.make_lr_schedule(*sched_args))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(pj)

    def run(offset):
        pt = {k: _t(v).requires_grad_(True) for k, v in p0.items()}
        o = torch.optim.Adam(list(pt.values()), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        sched = tsch.make_lr_schedule(*sched_args)
        out = []
        for i, g in enumerate(grads):
            for k in pt:
                pt[k].grad = _t(g[k])
            for group in o.param_groups:
                group["lr"] = sched(i + offset)
            o.step()
            out.append({k: v.detach().numpy().copy() for k, v in pt.items()})
        return out

    ours, late = run(0), run(1)
    for i, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        for k in p0:
            _close(pj[k], ours[i][k], 1e-7)
    assert max(np.abs(late[-1][k] - np.asarray(pj[k])).max() for k in p0) > 1e-5


# ---- one whole training step against the JAX step --------------------


def _capture():
    """An optax transformation whose state after ``update`` is the
    gradient it was given (masked, for packed state), so the JAX step
    hands back its gradients exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _lift_sigma(p, by=2.0):
    if jf.is_packed(p):
        return {**p, "b_sig": p["b_sig"].at[0, 0].add(by)}
    return {**p, "sigma": {**p["sigma"], "bias": p["sigma"]["bias"] + by}}


def _step_case(jcfg, tcfg_m, rcfg_kw, tcfg_kw, n_pairs, classes, semantic_mask, seed):
    rng = np.random.default_rng(seed)
    rcfg_j = jp.RenderConfig(perturb=0.0, raw_noise_std=0.0, **rcfg_kw)
    rcfg_t = tp.RenderConfig(perturb=0.0, raw_noise_std=0.0, **rcfg_kw)
    tj = jstep.TrainConfig(n_rays=n_pairs, **tcfg_kw)
    tt = tstep.TrainConfig(n_rays=n_pairs, **tcfg_kw)

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, -0.1, -2.5]
    h, w = 4, 2 * n_pairs // 4
    rays = np.asarray(j_create_rays(jnp.asarray(c2w), h, w, 3.0, 3.0, (w - 1) / 2, (h - 1) / 2,
                                    0.5, 5.0))[0]
    rgb = rng.uniform(0.05, 0.95, size=(2 * n_pairs, 3)).astype(np.float32)
    if semantic_mask:
        sem = (rng.uniform(size=2 * n_pairs) > 0.3).astype(np.float32)
    else:
        sem = rng.integers(0, classes + 1, size=2 * n_pairs).astype(np.int32)
    jbatch = JBatch(rays=jnp.asarray(rays), rgb=jnp.asarray(rgb), depth=None,
                    semantic=jnp.asarray(sem), sem_flag=jnp.float32(1.0),
                    image_idx=jnp.int32(0))
    tbatch = tsamp.RayBatch(rays=_t(rays), rgb=_t(rgb), depth=None,
                            semantic=torch.from_numpy(sem), sem_flag=torch.tensor(1.0),
                            image_idx=torch.tensor(0))
    n_tab = max(classes, 1)
    per = _per_class(rng, n_tab, 32) if classes else [_per_class(rng, 1, 32)[0]]
    table_j = ja.table_from_numpy(per, 32)
    table_t = ta.table_from_numpy(per, 32, device="cpu")

    opt = _capture()
    state_j = jstep.create_train_state(jax.random.key(seed), jcfg, tj, opt)
    # a positive sigma bias, so that no level starts with sigma <= 0 at
    # every sample (and so with no gradient at all)
    state_j = state_j._replace(params_coarse=_lift_sigma(state_j.params_coarse),
                               params_fine=_lift_sigma(state_j.params_fine))
    step_j = jax.jit(jstep.make_train_step(jcfg, rcfg_j, tj, opt, h, w,
                                           sample_fn=lambda k, p, s: jbatch))
    new_j, rep_j = step_j(state_j, None, table_j, jnp.float32(0.5), jax.random.key(1))

    state_t = tstep.create_train_state(tcfg_m, tt, device="cpu")
    assert isinstance(state_t.model_fine, tm.PackedMLP) == jf.is_packed(state_j.params_fine)
    for model, pj in ((state_t.model_coarse, state_j.params_coarse),
                      (state_t.model_fine, state_j.params_fine)):
        _load_jax(model, pj, jcfg)
    step_t = tstep.make_train_step(tcfg_m, rcfg_t, tt, h, w, sample_fn=lambda g, p, s: tbatch)
    rep_t = step_t(state_t, None, table_t, 0.5, torch.Generator().manual_seed(0))
    assert state_t.step == 1 and int(new_j.step) == 1

    grads = []
    for model, gj in ((state_t.model_coarse, new_j.opt_state["coarse"]),
                      (state_t.model_fine, new_j.opt_state["fine"])):
        got, ref, named = _level_grads(model, gj, jcfg)
        assert all(named[k].abs().max() > 0 for k in named), "a parameter got no gradient"
        grads.append((got, ref))
    return rep_j, rep_t, grads


def _load_jax(model, pj, jcfg):
    """A JAX level's weights into the port's model: packed state straight
    into packed state (``packed_from_jax``), else through the reference
    layout."""
    pj = jax.tree_util.tree_map(np.asarray, pj)
    if isinstance(model, tm.PackedMLP):
        flat = packed_from_jax(pj, "cpu")
        with torch.no_grad():
            model.weight.copy_(flat.weight)
            model.bias.copy_(flat.bias)
        return
    model.load_state_dict(params_from_jax(jf.unpack_weights(pj, jcfg) if jf.is_packed(pj)
                                          else pj, "cpu"))


def _level_grads(model, gj, jcfg):
    """(port, JAX) gradients of one level as flat arrays, and the port's
    by reference parameter name.  On packed state these are the masked
    packed buffers against JAX's masked packed gradients, directly, each
    exactly zero on the padded slots."""
    gj = jax.tree_util.tree_map(np.asarray, gj)
    if isinstance(model, tm.PackedMLP):
        ref = packed_from_jax(gj, "cpu")
        got = torch.cat([model.weight.grad, model.bias.grad]).numpy()
        ref = torch.cat([ref.weight, ref.bias]).numpy()
        pad = torch.cat([model.weight_mask, model.bias_mask]).numpy() == 0
        assert not got[pad].any() and not ref[pad].any()
        return got, ref, model.unpack(fm.FlatBlocks(model.weight.grad, model.bias.grad))
    ref = params_from_jax(jf.unpack_weights(gj, jcfg) if jf.is_packed(gj) else gj, "cpu")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(ref)
    return (np.concatenate([got[k].numpy().ravel() for k in sorted(got)]),
            np.concatenate([ref[k].numpy().ravel() for k in sorted(got)]), got)


def test_train_step_fused_matches_jax():
    kw = dict(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=7,
              use_fused_kernel=True)
    rep_j, rep_t, grads = _step_case(
        jm.MLPConfig(compute_dtype=jnp.bfloat16, **kw),
        tm.MLPConfig(compute_dtype=torch.bfloat16, **kw),
        dict(n_coarse=16, n_importance=16), {}, n_pairs=16, classes=7,
        semantic_mask=False, seed=20)
    assert rep_t._fields == rep_j._fields
    for name in rep_j._fields:
        a, b = float(getattr(rep_j, name)), float(getattr(rep_t, name))
        assert np.isfinite(b) and abs(a - b) <= 1e-3 * max(abs(a), 1e-6), (name, a, b)
    assert float(rep_t.reflect_cluster) > 0 and float(rep_t.semantic) > 0
    for got, ref in grads:  # coarse, fine
        cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos > 0.999, cos


@pytest.mark.parametrize("ablation", [dict(no_cluster=True), dict(no_intrinsic_loss=True),
                                      dict(mask_mode="mask")],
                         ids=["no_cluster", "no_intrinsic_loss", "mask_mode_mask"])
def test_train_step_unfused_fp32_matches_jax(ablation):
    mask = ablation.get("mask_mode") == "mask"
    kw = dict(depth=4, width=32, skips=(2,), n_freqs_pos=6, n_freqs_dir=3,
              pos_scalar_factor=10.0, enable_semantic=not mask,
              num_semantic_classes=0 if mask else 4)
    rep_j, rep_t, grads = _step_case(
        jm.MLPConfig(**kw), tm.MLPConfig(**kw), dict(n_coarse=12, n_importance=12),
        ablation, n_pairs=12, classes=0 if mask else 4, semantic_mask=mask, seed=21)
    for name in rep_j._fields:
        _close(getattr(rep_j, name), getattr(rep_t, name), 1e-5)
    if ablation.get("no_cluster"):
        assert float(rep_t.reflect_cluster) == 0.0
    else:
        assert float(rep_t.reflect_cluster) > 0
    for got, ref in grads:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_train_step_learns_and_trains_every_linear():
    """Twenty CPU steps on one fixed batch lower the loss; every
    parameter of both levels gets a gradient."""
    mcfg = tm.MLPConfig(depth=4, width=32, skips=(2,), n_freqs_pos=4, n_freqs_dir=2,
                        enable_semantic=True, num_semantic_classes=4)
    rng = np.random.default_rng(30)
    pools = _pools(rng)
    tt = tstep.TrainConfig(n_rays=16)
    rcfg = tp.RenderConfig(n_coarse=8, n_importance=8, raw_noise_std=1.0)
    state = tstep.create_train_state(mcfg, tt, device="cpu", generator=torch.Generator().manual_seed(1))
    step = tstep.make_train_step(mcfg, rcfg, tt, H, W)
    dp = tstep.DataPools(rays=_t(pools["rays"]), rgb=_t(pools["rgb"]),
                         semantic=torch.from_numpy(pools["semantic"]),
                         mask_ids=torch.from_numpy(pools["mask_ids"]))
    table = ta.empty_cluster_table(4, 8, device="cpu")
    totals = []
    for _ in range(20):
        rep = step(state, dp, table, 0.1, torch.Generator().manual_seed(7))  # one fixed batch
        totals.append(float(rep.total))
        assert all(np.isfinite(float(v)) for v in rep)
    assert totals[-1] < 0.95 * totals[0], totals
    for model in (state.model_coarse, state.model_fine):
        for name, p in model.named_parameters():
            assert p.grad is not None and p.grad.abs().max() > 0, name
    assert dataclasses.asdict(tt)["n_rays"] == 16 and state.step == 20


def test_cluster_target_carries_no_gradient():
    """The cluster target is made from the fine albedo without gradient:
    with the pass-through (empty) table the fine level's cluster term is
    mse(albedo_f, albedo_f) and the coarse level's pulls albedo_c toward
    a constant, so the fine gradients do not depend on w_c while the
    coarse ones do.  Without the detach the coarse term would reach the
    fine parameters."""
    mcfg = tm.MLPConfig(depth=4, width=32, skips=(2,), n_freqs_pos=4, n_freqs_dir=2,
                        enable_semantic=True, num_semantic_classes=4)
    pools = _pools(np.random.default_rng(31))
    tt = tstep.TrainConfig(n_rays=12)
    rcfg = tp.RenderConfig(n_coarse=8, n_importance=8)
    dp = tstep.DataPools(rays=_t(pools["rays"]), rgb=_t(pools["rgb"]),
                         semantic=torch.from_numpy(pools["semantic"]))
    table = ta.empty_cluster_table(4, 8, device="cpu")
    grads = []
    for w_c in (0.0, 5.0):
        state = tstep.create_train_state(mcfg, tt, device="cpu")
        tstep.make_train_step(mcfg, rcfg, tt, H, W)(state, dp, table, w_c,
                                                     torch.Generator().manual_seed(3))
        grads.append([torch.cat([p.grad.flatten() for p in m.parameters()])
                      for m in (state.model_coarse, state.model_fine)])
    (c0, f0), (c5, f5) = grads
    torch.testing.assert_close(f5, f0, atol=1e-7, rtol=1e-5)
    assert float((c5 - c0).abs().max()) > 1e-4
