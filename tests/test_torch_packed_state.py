"""The packed training state (``models/mlp.py:PackedMLP``, the twin of the
JAX ``packs_state``) on the CPU, at depth 8, width 32, C = 5.

Inputs are made with numpy from fixed seeds.  The kernels' plain versions
serve the port's CPU tensors; the JAX step runs its Pallas kernels in
interpret mode.  Tolerances:

- packed against unpacked port steps, from the same generator and draws:
  bitwise, losses, the unpacked weights and Adam's unpacked moments over
  six steps (Adam is elementwise and the padded slots carry zero
  gradients and moments, so the two layouts take the same steps);
- the port's packed step against the JAX packed-state step from the same
  packed weights and batch: loss terms within 1e-3 relative, masked
  packed gradients with cosine > 0.999 per level (the bf16 roundings
  agree, the fp32 sums do not); the padded slots get exactly zero
  gradient and stay exactly where they were after an Adam step, in both
  packages;
- checkpoints and the weight bridge: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intrinsicnerf_tpu.cluster import assign as ja
from intrinsicnerf_tpu.core.rays import create_rays as j_create_rays
from intrinsicnerf_tpu.data.samplers import RayBatch as JBatch
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.ops import fused_mlp as jf
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu.tools import import_ckpt as jic
from intrinsicnerf_tpu.train import schedules as jsch
from intrinsicnerf_tpu.train import step as jstep
from intrinsicnerf_tpu_torch.cluster import assign as ta
from intrinsicnerf_tpu_torch.data import samplers as tsamp
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.tools import import_ckpt as tic
from intrinsicnerf_tpu_torch.train import checkpoint as tck
from intrinsicnerf_tpu_torch.train import step as tstep
from test_torch_train import H, W, _capture, _per_class, _pools

KW = dict(width=32, pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=5,
          use_fused_kernel=True)
MCFG = tm.MLPConfig(compute_dtype=torch.bfloat16, **KW)
JCFG = jm.MLPConfig(compute_dtype=jnp.bfloat16, **KW)
# the object pipeline's shape of the state: no semantic head, mask losses
MCFG_OBJ = dataclasses.replace(MCFG, enable_semantic=False, num_semantic_classes=0,
                               pos_scalar_factor=1.0)
RCFG = tp.RenderConfig(n_coarse=8, n_importance=8)
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sin():
    """The first parallel fp32 ``torch.sin`` of a process can compute one
    thread's chunk to ~2,500 ulp, where every later call is within 1 ulp;
    a bitwise comparison of two runs must not let one of them make that
    call."""
    torch.sin(torch.zeros(1 << 16))


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _lift(state, by=2.0):
    """A positive sigma bias, so both levels render and get gradients."""
    for m in (state.model_coarse, state.model_fine):
        sd = m.state_dict()
        sd["alpha_linear.bias"] += by
        m.load_state_dict(sd)


def _scene(mcfg, seed=40):
    rng = np.random.default_rng(seed)
    classes = max(mcfg.num_semantic_classes, 1)
    pools = _pools(rng, classes=classes)
    tcfg = tstep.TrainConfig(n_rays=8, mask_mode="label" if mcfg.enable_semantic else "mask")
    sem = pools["semantic"] if mcfg.enable_semantic else (pools["semantic"] > 0).astype(np.float32)
    dp = tstep.DataPools(rays=_t(pools["rays"]), rgb=_t(pools["rgb"]),
                         semantic=torch.from_numpy(sem),
                         mask_ids=torch.from_numpy(pools["mask_ids"]))
    table = ta.table_from_numpy(_per_class(rng, classes, 16), 16, device="cpu")
    return tcfg, dp, table


def _train(mcfg, packed, steps=STEPS, state=None, generator=None):
    tcfg, dp, table = _scene(mcfg)
    if state is None:
        state = tstep.create_train_state(mcfg, tcfg, device="cpu", packed=packed,
                                         generator=torch.Generator().manual_seed(2))
        _lift(state)
    g = generator if generator is not None else torch.Generator().manual_seed(9)
    step = tstep.make_train_step(mcfg, RCFG, tcfg, H, W)
    reps = [torch.stack(list(step(state, dp, table, 0.5, g))) for _ in range(steps)]
    return state, reps, g


def _adam_unpacked(state):
    """Adam's moments in the unpacked layout, as a checkpoint keeps them."""
    return tck.optimizer_state_dict(state)["state"]


@pytest.mark.parametrize("mcfg", [MCFG, MCFG_OBJ], ids=["scene", "object"])
def test_packed_steps_equal_unpacked_steps_bitwise(mcfg):
    packed, reps_p, _ = _train(mcfg, packed=True)
    plain, reps_u, _ = _train(mcfg, packed=False)
    assert isinstance(packed.model_fine, tm.PackedMLP)
    assert isinstance(plain.model_fine, tm.IntrinsicMLP)
    assert len(packed.optimizer.param_groups[0]["params"]) == 4  # two buffers a level
    for i, (a, b) in enumerate(zip(reps_p, reps_u)):
        assert torch.equal(a, b), (i, a, b)
    for mp, mu in ((packed.model_coarse, plain.model_coarse),
                   (packed.model_fine, plain.model_fine)):
        sp, su = mp.state_dict(), mu.state_dict()
        assert list(sp) == list(su)
        for k in su:
            assert torch.equal(sp[k], su[k]), k
    ap, au = _adam_unpacked(packed), plain.optimizer.state_dict()["state"]
    assert sorted(ap) == sorted(au)
    for i in au:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ap[i][name], au[i][name]), (i, name)
    # the padded slots never moved: still exactly zero
    for m in (packed.model_coarse, packed.model_fine):
        assert not m.weight[m.weight_mask == 0].any() and not m.bias[m.bias_mask == 0].any()


def test_training_path_never_packs_or_unflattens(monkeypatch):
    """A packed step goes through the flat buffers alone: the pack of the
    live parameters and the per-block scatter of kernel 2's gradients are
    the unpacked path's, and a packed step calls neither.  Kernel 1's
    weight image is asked for once per forward (coarse, fine), never by
    the backward."""
    calls = []
    for name in ("pack_weights", "_unflatten_grads", "kernel_buffers", "_image_for"):
        fn = getattr(fm, name)
        monkeypatch.setattr(fm, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    tcfg, dp, table = _scene(MCFG)
    state = tstep.create_train_state(MCFG, tcfg, device="cpu")
    step = tstep.make_train_step(MCFG, RCFG, tcfg, H, W)
    calls.clear()
    step(state, dp, table, 0.5, torch.Generator().manual_seed(1))
    assert calls == ["_image_for", "_image_for"]
    assert state.model_fine.weight.grad.shape == (fm.flatten_blocks(
        fm.pack_weights(tm.IntrinsicMLP(MCFG, "cpu").state_dict(), MCFG)).weight.shape)


# ---- against the JAX packed-state step ---------------------------------


def _jax_case(optimizer, seed=41, n_pairs=8):
    """One step of both packages from the same packed weights and batch
    (perturb 0, no sigma noise: neither side draws).  Returns the JAX
    state before and after, its report, and the port's state and report."""
    rng = np.random.default_rng(seed)
    rcfg_kw = dict(n_coarse=8, n_importance=8, perturb=0.0, raw_noise_std=0.0)
    tj, tt = jstep.TrainConfig(n_rays=n_pairs), tstep.TrainConfig(n_rays=n_pairs)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, -0.1, -2.5]
    h, w = 4, 2 * n_pairs // 4
    rays = np.asarray(j_create_rays(jnp.asarray(c2w), h, w, 3.0, 3.0, (w - 1) / 2,
                                    (h - 1) / 2, 0.5, 5.0))[0]
    rgb = rng.uniform(0.05, 0.95, size=(2 * n_pairs, 3)).astype(np.float32)
    sem = rng.integers(0, 6, size=2 * n_pairs).astype(np.int32)
    jbatch = JBatch(rays=jnp.asarray(rays), rgb=jnp.asarray(rgb), depth=None,
                    semantic=jnp.asarray(sem), sem_flag=jnp.float32(1.0), image_idx=jnp.int32(0))
    tbatch = tsamp.RayBatch(rays=_t(rays), rgb=_t(rgb), depth=None, semantic=torch.from_numpy(sem),
                            sem_flag=torch.tensor(1.0), image_idx=torch.tensor(0))
    per = _per_class(rng, 5, 16)
    assert jstep.packs_state(JCFG) and tstep.packs_state(MCFG)
    state_j = jstep.create_train_state(jax.random.key(seed), JCFG, tj, optimizer)
    lift = lambda p: {**p, "b_sig": p["b_sig"].at[0, 0].add(2.0)}  # noqa: E731
    state_j = state_j._replace(params_coarse=lift(state_j.params_coarse),
                               params_fine=lift(state_j.params_fine))
    step_j = jax.jit(jstep.make_train_step(JCFG, jp.RenderConfig(**rcfg_kw), tj, optimizer, h, w,
                                           sample_fn=lambda k, p, s: jbatch))
    new_j, rep_j = step_j(state_j, None, ja.table_from_numpy(per, 16), jnp.float32(0.5),
                          jax.random.key(1))

    state_t = tstep.create_train_state(MCFG, tt, device="cpu")
    with torch.no_grad():
        for m, pj in ((state_t.model_coarse, state_j.params_coarse),
                      (state_t.model_fine, state_j.params_fine)):
            flat = tic.packed_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
            m.weight.copy_(flat.weight)
            m.bias.copy_(flat.bias)
    step_t = tstep.make_train_step(MCFG, tp.RenderConfig(**rcfg_kw), tt, h, w,
                                   sample_fn=lambda g, p, s: tbatch)
    rep_t = step_t(state_t, None, ta.table_from_numpy(per, 16, device="cpu"), 0.5,
                   torch.Generator().manual_seed(0))
    return state_j, new_j, rep_j, state_t, rep_t


def _flat_np(tree):
    flat = tic.packed_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    return flat.weight.numpy(), flat.bias.numpy()


def test_packed_step_matches_jax_packed_step():
    _, new_j, rep_j, state_t, rep_t = _jax_case(_capture())
    for name in rep_j._fields:
        a, b = float(getattr(rep_j, name)), float(getattr(rep_t, name))
        assert np.isfinite(b) and abs(a - b) <= 1e-3 * max(abs(a), 1e-6), (name, a, b)
    assert float(rep_t.reflect_cluster) > 0 and float(rep_t.semantic) > 0
    for m, gj in ((state_t.model_coarse, new_j.opt_state["coarse"]),
                  (state_t.model_fine, new_j.opt_state["fine"])):
        ref = np.concatenate(_flat_np(gj))  # JAX's masked packed gradients, flat
        got = torch.cat([m.weight.grad, m.bias.grad]).numpy()
        mask = torch.cat([m.weight_mask, m.bias_mask]).numpy()
        cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos > 0.999, cos
        assert not got[mask == 0].any() and not ref[mask == 0].any()
        # every reference parameter has a gradient
        unpacked = m.unpack(fm.FlatBlocks(m.weight.grad, m.bias.grad))
        assert all(v.abs().max() > 0 for v in unpacked.values())


def test_padded_slots_stay_put_under_adam_in_both_packages():
    opt = optax.adam(jsch.make_lr_schedule(5e-4, 250e3))
    state_j, new_j, _, state_t, _ = _jax_case(opt, seed=42)
    for m, before, after in ((state_t.model_coarse, state_j.params_coarse, new_j.params_coarse),
                             (state_t.model_fine, state_j.params_fine, new_j.params_fine)):
        mask = torch.cat([m.weight_mask, m.bias_mask]).numpy()
        b, a = np.concatenate(_flat_np(before)), np.concatenate(_flat_np(after))
        got = torch.cat([m.weight, m.bias]).detach().numpy()
        assert np.array_equal(a[mask == 0], b[mask == 0]) and not a[mask == 0].any()
        assert np.array_equal(got[mask == 0], b[mask == 0])
        assert (got[mask == 1] != b[mask == 1]).mean() > 0.5  # the real slots moved
        np.testing.assert_allclose(got, a, atol=2e-6)  # Adam's first step: ~lr per slot


# ---- the weight bridge and checkpoints ---------------------------------


def test_bridge_carries_jax_packed_state_both_ways():
    pj = jf.pack_weights(jm.init_mlp_params(jax.random.key(3), JCFG), JCFG)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    m = tm.PackedMLP(MCFG, device="cpu")
    with torch.no_grad():
        flat = tic.packed_from_jax(tree, "cpu")
        m.weight.copy_(flat.weight)
        m.bias.copy_(flat.bias)
    back = tic.packed_to_jax(m)
    assert sorted(back) == sorted(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)
    # the reference layout agrees with the JAX unpack of the same blocks
    ref = tic.params_from_jax(jax.tree_util.tree_map(np.asarray, jf.unpack_weights(pj, JCFG)),
                              "cpu")
    sd = m.state_dict()
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k


def test_packed_state_dict_as_a_submodule():
    """Nested in another module, a ``PackedMLP`` gives its reference
    entries under the parent's prefix and loads them back; with
    ``strict=False`` a missing entry keeps its value, and both a missing
    and an unexpected entry are reported."""
    parent = torch.nn.ModuleDict({"net": tm.PackedMLP(MCFG, device="cpu")})
    want = tm.IntrinsicMLP(MCFG, "cpu", generator=torch.Generator().manual_seed(9)).state_dict()
    sd = parent.state_dict()
    assert sorted(sd) == sorted(f"net.{k}" for k in want)
    before = parent["net"].state_dict()["alpha_linear.bias"].clone()
    partial = {f"net.{k}": v for k, v in want.items() if k != "alpha_linear.bias"}
    with pytest.raises(RuntimeError, match="Missing key"):
        parent.load_state_dict(partial)
    res = parent.load_state_dict({**partial, "net.extra": before}, strict=False)
    assert res.missing_keys == ["net.alpha_linear.bias"] and res.unexpected_keys == ["net.extra"]
    got = parent["net"].state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], before if k == "alpha_linear.bias" else v), k
    with pytest.raises(RuntimeError, match="Unexpected key"):
        parent.load_state_dict({**sd, "net.extra": before})
    assert parent.state_dict(keep_vars=True)["net.pts_linears.0.weight"].requires_grad


def test_packed_and_unpacked_models_evaluate_alike():
    """The serving operands, the unfused path (a packed model unpacked
    first) and its gradient, from one generator in both layouts."""
    pm = tm.PackedMLP(MCFG, device="cpu", generator=torch.Generator().manual_seed(4))
    um = tm.IntrinsicMLP(MCFG, device="cpu", generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(43)
    pts = _t(rng.normal(size=(6, 5, 3)))
    dirs = torch.nn.functional.normalize(_t(rng.normal(size=(6, 3))), dim=-1)
    with torch.no_grad():
        a, b = (tm.eval_points(m, MCFG, pts, dirs) for m in (pm, um))
    for f in ("rgb", "sigma", "sem_logits"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    a, b = (tm.eval_points(m, MCFG, pts, dirs, want_endpoint_feat=True) for m in (pm, um))
    for f in ("rgb", "sigma", "sem_logits", "endpoint_feat"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    (a.rgb.sum() + a.sem_logits.sum()).backward()
    (b.rgb.sum() + b.sem_logits.sum()).backward()
    grads = pm.unpack(fm.FlatBlocks(pm.weight.grad, pm.bias.grad))
    for k, p in um.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)  # alpha_linear: unused here
        assert torch.equal(grads[k], want), k
    assert not pm.weight.grad[pm.weight_mask == 0].any()  # the unpack feeds real slots only


def _ckpt_pair(tmp_path):
    """A packed run of six steps, and the same run saved after three and
    resumed in a fresh state for three more."""
    full, reps_full, _ = _train(MCFG, packed=True)
    first, _, g = _train(MCFG, packed=True, steps=3)
    ck = tck.Checkpointer(str(tmp_path / "ck"))
    ck.save(first, 3, generator=g)
    ck.wait()
    return full, reps_full, first, ck


def test_packed_resume_equals_the_unbroken_run(tmp_path):
    full, reps_full, _, ck = _ckpt_pair(tmp_path)
    tcfg, _, _ = _scene(MCFG)
    resumed = tstep.create_train_state(MCFG, tcfg, device="cpu",
                                       generator=torch.Generator().manual_seed(77))
    g = torch.Generator()
    assert ck.restore(resumed, generator=g) == 3 and int(resumed.step_t) == 3
    _, reps, _ = _train(MCFG, packed=True, steps=3, state=resumed, generator=g)
    for a, b in zip(reps, reps_full[3:]):
        assert torch.equal(a, b)
    for ma, mb in ((resumed.model_coarse, full.model_coarse), (resumed.model_fine, full.model_fine)):
        assert torch.equal(ma.weight, mb.weight) and torch.equal(ma.bias, mb.bias)
    for p, q in zip(*(s.optimizer.param_groups[0]["params"] for s in (resumed, full))):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed.optimizer.state[p][name], full.optimizer.state[q][name])
    ck.close()


def test_packed_checkpoint_loads_unpacked_and_into_jax(tmp_path):
    _, _, first, ck = _ckpt_pair(tmp_path)
    path = tck.checkpoint_path(ck.ckpt_dir, 3)
    ckpt = torch.load(path, map_location="cpu")
    sd_ref = ckpt["network_fine_state_dict"]
    assert sorted(sd_ref) == sorted(tm.IntrinsicMLP(MCFG, "cpu").state_dict())
    # the unpacked path loads the file as it is: weights and Adam's state
    tcfg, _, _ = _scene(MCFG)
    plain = tstep.create_train_state(MCFG, tcfg, device="cpu", packed=False)
    assert tck.Checkpointer(ck.ckpt_dir).restore(plain) == 3
    for mp, mu in ((first.model_coarse, plain.model_coarse), (first.model_fine, plain.model_fine)):
        sp = mp.state_dict()
        for k, v in mu.state_dict().items():
            assert torch.equal(v, sp[k]), k
    want = _adam_unpacked(first)
    got = plain.optimizer.state_dict()["state"]
    for i in want:
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][name], want[i][name]), (i, name)
    # the JAX import packs the same weights
    state_j, mcfg_j = jic.import_reference_checkpoint(path, mcfg=JCFG)
    assert int(state_j.step) == 3
    for m, pj in ((first.model_coarse, state_j.params_coarse),
                  (first.model_fine, state_j.params_fine)):
        mine = tic.packed_to_jax(m)
        for k, v in pj.items():
            np.testing.assert_array_equal(np.asarray(v), mine[k], err_msg=k)
    # and the port's reader and load_state_dict pack it into a fresh packed state
    fresh = tstep.create_train_state(MCFG, tcfg, device="cpu")
    step, sd_c, sd_f = tic.load_reference_checkpoint(path)
    assert step == 3
    fresh.model_coarse.load_state_dict(tic.to_port_state_dict(sd_c))
    fresh.model_fine.load_state_dict(tic.to_port_state_dict(sd_f))
    assert torch.equal(fresh.model_fine.weight, first.model_fine.weight)
    assert torch.equal(fresh.model_coarse.bias, first.model_coarse.bias)
    ck.close()
