"""MLP and fused-kernel parity of the PyTorch port against the JAX package.

Weights are made by the JAX package's ``init_mlp_params`` and carried
into the port through ``params_from_jax``.  Tolerances:

- weight carry-over and ``pack_weights``: bit-exact (pure copies);
- unfused ``eval_points`` at fp32: atol 1e-5 (matmul summation order);
- the fused kernel's plain version against the JAX fused path (Pallas in
  interpret mode on the CPU): max |d| / max(|ref|, 1) < 2e-2, the bound
  of ``tests/test_fused_mlp.py``.  Both sides round the same operands to
  bf16, so the observed error is far smaller.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.ops import fused_mlp as jf
from intrinsicnerf_tpu.tools import import_ckpt as jic
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.ops import fused_mlp as tf
from intrinsicnerf_tpu_torch.tools import import_ckpt as tic
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax, params_to_jax

HEADS = ("sigma", "albedo", "shading", "residual", "sem_logits", "rgb")


def _cfgs(sem=True, C=7, compute_dtype=torch.float32, **kw):
    common = dict(pos_scalar_factor=10.0, enable_semantic=sem,
                  num_semantic_classes=C if sem else 0, **kw)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[compute_dtype]
    return (jm.MLPConfig(compute_dtype=jdt, **common),
            tm.MLPConfig(compute_dtype=compute_dtype, **common))


def _models(jcfg, tcfg, seed=0, cls=tm.IntrinsicMLP):
    params = jax.tree_util.tree_map(np.asarray, jm.init_mlp_params(jax.random.key(seed), jcfg))
    model = cls(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return params, model


def _points(n=8, s=16, seed=1):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, s, 3)) * 2).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return pts, d


@pytest.mark.parametrize("sem", [True, False])
def test_weight_carry_over_round_trip(sem):
    jcfg, tcfg = _cfgs(sem)
    params, model = _models(jcfg, tcfg)
    back = params_to_jax(model)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_is_seeded_torch_default():
    _, tcfg = _cfgs()
    a = tm.IntrinsicMLP(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = tm.IntrinsicMLP(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
        bound = 1.0 / x.shape[-1] ** 0.5 if k.endswith("weight") else None
        if bound is not None:
            assert float(x.abs().max()) <= bound
    assert sorted(a.state_dict()) == sorted(params_from_jax(params_to_jax(a), "cpu"))


@pytest.mark.parametrize("viewdirs", [True, False])
def test_unfused_eval_points_fp32(viewdirs):
    jcfg, tcfg = _cfgs(width=64, use_viewdirs=viewdirs)
    params, model = _models(jcfg, tcfg)
    pts, d = _points()
    a = jm.eval_points(params, jcfg, jnp.asarray(pts), jnp.asarray(d) if viewdirs else None)
    b = tm.eval_points(model, tcfg, torch.from_numpy(pts), torch.from_numpy(d) if viewdirs else None)
    for name in HEADS:
        np.testing.assert_allclose(getattr(b, name).detach().numpy(),
                                   np.asarray(getattr(a, name)), atol=1e-5, err_msg=name)


def test_unfused_bf16_trunk_runs():
    jcfg, tcfg = _cfgs(width=64, compute_dtype=torch.bfloat16)
    params, model = _models(jcfg, tcfg)
    pts, d = _points()
    a = jm.eval_points(params, jcfg, jnp.asarray(pts), jnp.asarray(d))
    b = tm.eval_points(model, tcfg, torch.from_numpy(pts), torch.from_numpy(d))
    for name in HEADS:  # bf16 trunk: bf16-level agreement
        x, y = np.asarray(getattr(a, name)), getattr(b, name).detach().numpy()
        assert np.max(np.abs(x - y)) / max(np.abs(x).max(), 1.0) < 2e-2, name


@pytest.mark.parametrize("sem", [True, False])
def test_pack_weights_bit_exact(sem):
    jcfg, tcfg = _cfgs(sem)
    params, model = _models(jcfg, tcfg)
    a = jf.pack_weights(params, jcfg)
    b = tf.pack_weights(model.state_dict(), tcfg)
    assert tuple(b) == tf._PACKED_KEYS == jf._PACKED_KEYS
    for k in tf._PACKED_KEYS:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
    back = tf.unpack_weights(b, tcfg)
    assert sorted(back) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_pe_constants_and_in8():
    jcfg, tcfg = _cfgs()
    F, m = tf.pe_constants(tcfg)
    Fj, mj = jf.pe_constants(jcfg)
    np.testing.assert_array_equal(F.numpy(), np.asarray(Fj))
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    pts, d = _points()
    np.testing.assert_array_equal(
        tf.build_in8(torch.from_numpy(pts), torch.from_numpy(d)).numpy(),
        np.asarray(jf.build_in8(jcfg, jnp.asarray(pts), jnp.asarray(d))),
    )


@pytest.fixture(scope="module")
def fused_pair():
    jcfg, tcfg = _cfgs(compute_dtype=torch.bfloat16, use_fused_kernel=True)
    params, model = _models(jcfg, tcfg, cls=tm.PackedMLP)
    return jcfg, tcfg, params, model


def test_plain_fused_matches_pallas(fused_pair):
    jcfg, tcfg, params, model = fused_pair
    pts, d = _points()
    a = jf.fused_eval_points(params, jcfg, jnp.asarray(pts), jnp.asarray(d))
    b = tf.fused_eval_points(model.fused_operands(tcfg), tcfg, torch.from_numpy(pts),
                             torch.from_numpy(d))
    for name in HEADS:
        x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
        assert np.max(np.abs(x - y)) / max(np.abs(x).max(), 1.0) < 2e-2, name
    # the raw packed output, including the zero padding columns
    in8 = jf.build_in8(jcfg, jnp.asarray(pts), jnp.asarray(d))
    ra = np.asarray(jf.fused_mlp_apply(params, jcfg, in8))
    rb = tf.fused_mlp_apply(model.flat(), tcfg, torch.from_numpy(np.array(in8))).detach().float().numpy()
    assert np.max(np.abs(ra - rb)) / max(np.abs(ra).max(), 1.0) < 2e-2
    assert np.abs(rb[:, 8 + tcfg.num_semantic_classes:]).max() == 0.0


def test_eval_points_dispatches_to_plain_on_cpu(fused_pair):
    """With use_fused_kernel, CPU tensors go through the plain version
    (no kernel launch) and agree with the unfused bf16 model."""
    _, tcfg, _, model = fused_pair
    pts, d = _points(seed=4)
    before = tf.fused_mlp_forward.launches
    a = tm.eval_points(model, tcfg, torch.from_numpy(pts), torch.from_numpy(d))
    b = tm.eval_points(model, dataclasses.replace(tcfg, use_fused_kernel=False),
                       torch.from_numpy(pts), torch.from_numpy(d))
    assert tf.fused_mlp_forward.launches == before
    np.testing.assert_allclose(a.rgb.detach().numpy(), b.rgb.detach().numpy(), atol=2e-2)


def test_fused_operands_kept_until_weights_change(fused_pair):
    """The model makes its fused operands once, and makes them again
    after an in-place weight change (as an optimizer step or
    ``load_state_dict`` makes) or under another config."""
    _, tcfg, _, model = fused_pair
    m = copy.deepcopy(model)
    ops = m.fused_operands(tcfg)
    assert m.fused_operands(tcfg) is ops
    with torch.no_grad():
        m.weight.add_(1.0)
    changed = m.fused_operands(tcfg)
    assert changed is not ops and m.fused_operands(tcfg) is changed
    m.load_state_dict(model.state_dict())
    for got in (m.fused_operands(tcfg), model.fused_operands(tcfg)):
        want = tf.pack_weights(model.state_dict(), tcfg)
        assert all(torch.equal(got.packed[k], v) for k, v in want.items())
        made = (*tf.pe_constants(tcfg), *tf.kernel_buffers(tf.flatten_blocks(want)))
        assert all(torch.equal(x, y) for x, y in zip((*got.pe, got.wbuf, got.bbuf), made))
    other = dataclasses.replace(tcfg, pos_scalar_factor=3.0)
    assert torch.equal(m.fused_operands(other).pe[0], tf.pe_constants(other)[0])


def test_tools_operands_are_the_seeded_pack():
    """The kernel tools' operands, ``PackedMLP(seed 5).fused_operands`` at
    the Replica config they read, are bitwise the pack of the reference
    model made from the same seed."""
    from intrinsicnerf_tpu_torch.config import from_yaml
    from intrinsicnerf_tpu_torch.tools import bwd_passes

    mcfg = dataclasses.replace(from_yaml(bwd_passes.CONFIG).mlp,
                               num_semantic_classes=bwd_passes.N_CLASSES)
    assert tm.fuses(mcfg)
    ops = tm.PackedMLP(mcfg, device="cpu",
                       generator=torch.Generator().manual_seed(5)).fused_operands(mcfg)
    sd = tm.IntrinsicMLP(mcfg, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    want = tf.pack_weights(sd, mcfg)
    assert list(ops.packed) == list(want)
    assert all(torch.equal(ops.packed[k], v) for k, v in want.items())
    wbuf, bbuf = tf.kernel_buffers(tf.flatten_blocks(want))
    assert torch.equal(ops.wbuf.view(torch.int16), wbuf.view(torch.int16))
    assert torch.equal(ops.bbuf, bbuf)


@pytest.mark.parametrize("flavor", ["scene", "object"])
def test_reference_checkpoint_reading(tmp_path, flavor):
    """A reference checkpoint of either flavor: the port reads the same
    step, flavor and architecture as the JAX package, and its weights
    load into ``IntrinsicMLP`` as the JAX package's import of them."""
    jcfg, tcfg = _cfgs(sem=flavor == "scene")
    _, model = _models(jcfg, tcfg)
    sd = model.state_dict()
    if flavor == "object":  # the object-level NeRF's head names
        to_object = {v: k for k, v in tic.OBJECT_TO_PORT.items()}
        sd = {f"{to_object.get(mod, mod)}.{leaf}": v
              for (mod, _, leaf), v in ((k.rpartition("."), v) for k, v in sd.items())}
        ckpt = {"global_step": 7, "network_fn_state_dict": sd, "network_fine_state_dict": None}
    else:
        ckpt = {"global_step": 7, "network_coarse_state_dict": sd, "network_fine_state_dict": sd}
    path = str(tmp_path / "000007.ckpt")
    torch.save(ckpt, path)
    step, sd_c, sd_f = tic.load_reference_checkpoint(path)
    j_step, _, j_sd_f = jic.load_reference_checkpoint(path)
    assert step == j_step == 7
    assert (sd_f is None) == (j_sd_f is None) == (flavor == "object")
    assert tic.detect_flavor(sd_c) == jic.detect_flavor(sd_c) == flavor
    assert tic.infer_arch(sd_c) == jic.infer_arch(sd_c)
    loaded = tm.IntrinsicMLP(tcfg, device="cpu")
    loaded.load_state_dict(tic.to_port_state_dict(sd_c))
    ref = params_from_jax(jic.state_dict_to_params(sd_c), device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ref[k]) and torch.equal(v, model.state_dict()[k]), k
