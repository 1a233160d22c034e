"""The fused MLP's backward in the PyTorch port against the JAX package.

Weights come from the JAX package's ``init_mlp_params`` (width 256, the
reference architecture, C = 7) and reach the port through
``params_from_jax``; the JAX side runs its Pallas kernels in interpret
mode on the CPU, the port its kernels' plain versions.  Tolerances are
those of ``tests/test_fused_mlp.py``: gradient cosine > 0.999 and max
|d| < 1e-2 * max |ref|.  Both sides round the same operands to bf16 at
the same points, so the observed differences are far smaller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.ops import fused_mlp as jf
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.ops import fused_mlp as tf
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax

C = 7


def _cfgs(sem=True):
    kw = dict(pos_scalar_factor=10.0, enable_semantic=sem, num_semantic_classes=C if sem else 0,
              use_fused_kernel=True)
    return (jm.MLPConfig(compute_dtype=jnp.bfloat16, **kw),
            tm.MLPConfig(compute_dtype=torch.bfloat16, **kw))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 1, 3)) * 2).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["semantic", "no_semantic"])
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jax.tree_util.tree_map(np.asarray, jm.init_mlp_params(jax.random.key(0), jcfg))
    model = tm.IntrinsicMLP(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return jcfg, tcfg, params, model


def _cos_rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
    return cos, np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def loss_cotangent(out: np.ndarray, n_used: int, seed: int) -> np.ndarray:
    """The bf16 cotangent of ``0.5 * sum((out - target)^2) / P`` over the
    output columns a model reads (``[0, 8 + C)``), with a seeded uniform
    target: coherent across points, as a training loss's cotangent is.
    (Against a zero-mean random cotangent each dW entry is a random walk,
    and a single ReLU mask flipped by a rounding difference moves it by
    ~1/sqrt(P) of its size.)"""
    target = np.random.default_rng(seed).uniform(size=out.shape).astype(np.float32)
    g = (np.asarray(out, np.float32) - target) / out.shape[0]
    g[:, n_used:] = 0.0
    return g.astype(jnp.bfloat16)


def test_plain_backward_matches_jax_vjp(setup):
    """``fused_mlp_backward_plain`` against ``jax.vjp`` of the Pallas
    ``_fused_packed`` (one 2,048-point forward tile, two backward tiles)
    on the same bf16 cotangent: every packed block, padded slots
    included (both sides give them the same raw gradients)."""
    jcfg, tcfg, params, model = setup
    pts, d = _points(2048, 1)
    in8 = jf.build_in8(jcfg, jnp.asarray(pts), jnp.asarray(d))
    packed_j = jf.pack_weights(params, jcfg)
    tup = tuple(packed_j[k] for k in jf._PACKED_KEYS)
    pe = jf.pe_constants(jcfg)
    out, vjp = jax.vjp(lambda t: jf._fused_packed(t, pe, in8), tup)
    g = loss_cotangent(out, 8 + C, 2)
    (gj,) = vjp(jnp.asarray(g))

    packed_t = tf.pack_weights(model.state_dict(), tcfg)
    g_t = torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16)
    got = tf.fused_mlp_backward_plain(packed_t, tf.pe_constants(tcfg),
                                      torch.from_numpy(np.array(in8)), g_t)
    assert tuple(got) == tf._PACKED_KEYS
    allj = np.concatenate([np.asarray(x).ravel() for x in gj])
    allt = np.concatenate([got[k].numpy().ravel() for k in tf._PACKED_KEYS])
    cos, rel = _cos_rel(allt, allj)
    assert cos > 0.999 and rel < 1e-2, (cos, rel)
    for k, x in zip(jf._PACKED_KEYS, gj):
        assert got[k].shape == x.shape and got[k].dtype == torch.float32, k
        if np.abs(np.asarray(x)).max() == 0:  # a block with no gradient
            assert got[k].abs().max() == 0, k
            continue
        cos, rel = _cos_rel(got[k].numpy(), x)
        assert cos > 0.999 and rel < 1e-2, (k, cos, rel)


def _loss_j(f, params, cfg, pts, d):
    r = f(params, cfg, pts, d)
    loss = jnp.mean(r.rgb**2) + 0.01 * jnp.mean(r.sigma**2)
    return loss + (0.01 * jnp.mean(r.sem_logits**2) if cfg.enable_semantic else 0.0)


def _loss_t(r, cfg):
    loss = torch.mean(r.rgb**2) + 0.01 * torch.mean(r.sigma**2)
    return loss + (0.01 * torch.mean(r.sem_logits**2) if cfg.enable_semantic else 0.0)


def test_parameter_gradients_match_jax_grad(setup):
    """A loss on ``eval_points`` output: the port's grad-enabled fused
    path (live pack -> ``FusedMLP``) against ``jax.grad`` of the JAX
    fused path, per parameter of every ``nn.Linear``."""
    jcfg, tcfg, params, model = setup
    pts, d = _points(96, 3)
    pts = pts.reshape(8, 12, 3)
    d = d[:8]
    gj = jax.grad(lambda p: _loss_j(jf.fused_eval_points, p, jcfg, jnp.asarray(pts),
                                    jnp.asarray(d)))(params)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, gj), device="cpu")
    model.zero_grad(set_to_none=True)
    _loss_t(tm.eval_points(model, tcfg, torch.from_numpy(pts), torch.from_numpy(d)), tcfg).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(ref)
    allt = np.concatenate([got[k].numpy().ravel() for k in sorted(got)])
    allj = np.concatenate([ref[k].numpy().ravel() for k in sorted(got)])
    cos, rel = _cos_rel(allt, allj)
    assert cos > 0.999 and rel < 1e-2, (cos, rel)
    for k in got:  # every parameter of every nn.Linear gets its gradient
        assert got[k].abs().max() > 0, k
        cos, rel = _cos_rel(got[k].numpy(), ref[k].numpy())
        assert cos > 0.999 and rel < 1e-2, (k, cos, rel)


def test_pack_backward_is_the_mask_projection(setup):
    """The raw packed gradients are nonzero on padded slots (the shared
    output product feeds them); what reaches the parameters, packed
    again, equals the raw gradients times ``packed_grad_masks`` exactly,
    so the padded slots get exactly zero."""
    _, tcfg, _, model = setup
    pts, d = _points(64, 4)
    named = dict(model.named_parameters())
    packed = tf.pack_weights(named, tcfg)
    for v in packed.values():
        if v.requires_grad:
            v.retain_grad()
    model.zero_grad(set_to_none=True)
    r = tf.fused_eval_points(packed, tcfg, torch.from_numpy(pts), torch.from_numpy(d))
    _loss_t(r, tcfg).backward()
    masks = tf.packed_grad_masks(named, tcfg)
    back = tf.pack_weights({k: p.grad for k, p in named.items()}, tcfg)
    for k in tf._PACKED_KEYS:
        if packed[k].grad is None:  # the zero semantic blocks of a model without them
            assert not tcfg.enable_semantic and back[k].abs().max() == 0
            continue
        assert torch.equal(back[k], packed[k].grad * masks[k]), k
        assert back[k][masks[k] == 0].abs().max() == 0 if (masks[k] == 0).any() else True
    assert packed["w_sig"].grad[:, 1:].abs().max() > 0  # padded, yet fed by the other heads


def test_in8_and_pe_get_no_gradient(setup):
    _, tcfg, _, model = setup
    pts, d = _points(32, 5)
    in8 = tf.build_in8(torch.from_numpy(pts), torch.from_numpy(d)).requires_grad_(True)
    F, m = (t.clone().requires_grad_(True) for t in tf.pe_constants(tcfg))
    out = tf.fused_mlp_apply(dict(model.named_parameters()), tcfg, in8, pe=(F, m))
    out.sum().backward()
    assert in8.grad is None and F.grad is None and m.grad is None
    assert model.pts_linears[0].weight.grad is not None


def test_cotangent_is_bf16_and_cpu_launches_nothing(setup, monkeypatch):
    """The packed output is bf16, so the cotangent reaching the backward
    is bf16 as in JAX; on CPU tensors neither kernel launches."""
    _, tcfg, _, model = setup
    seen = []
    plain = tf.fused_mlp_backward_plain

    def spy(packed, pe, in8, g):
        seen.append(g.dtype)
        return plain(packed, pe, in8, g)

    monkeypatch.setattr(tf, "fused_mlp_backward_plain", spy)
    before = (tf.fused_mlp_forward.launches, tf.fused_mlp_backward.launches)
    pts, d = _points(16, 6)
    r = tm.eval_points(model, tcfg, torch.from_numpy(pts), torch.from_numpy(d))
    torch.mean(r.rgb).backward()
    assert seen == [torch.bfloat16]
    assert (tf.fused_mlp_forward.launches, tf.fused_mlp_backward.launches) == before


def test_kernel_flat_layout_round_trip(setup):
    """Kernel 2 returns flat fp32 gradients in the layouts of
    ``kernel_buffers`` (weights in ``_W_ORDER``, biases in ``_B_ORDER``,
    then one out-bias vector); ``_unflatten_grads`` cuts them back into
    the packed blocks and gives the out-bias vector to each output bias."""
    _, tcfg, _, model = setup
    packed = tf.pack_weights(model.state_dict(), tcfg)
    dw = torch.cat([packed[k].reshape(-1) for k in tf._W_ORDER])
    out = torch.arange(tf.OUT_W, dtype=torch.float32)[None]
    db = torch.cat([packed[k].reshape(-1) for k in tf._B_ORDER] + [out.reshape(-1)])
    wbuf, bbuf = tf.kernel_buffers(packed)
    assert (dw.numel(), db.numel()) == (wbuf.numel(), bbuf.numel()) == (835_584, 2_944)
    back = tf._unflatten_grads(dw, db, packed)
    for k in tf._PACKED_KEYS:
        want = out if k in tf._B_OUT else packed[k]
        assert torch.equal(back[k], want), k


@pytest.mark.parametrize("n,splits", [(1, 1), (4096, 1), (4097, 2), (12_289, 4),
                                      (65_536, 5), (196_608, 5), (10**7, 5)])
def test_backward_splits(n, splits):
    assert tf.backward_splits(n) == splits


def test_backward_refuses_other_devices(setup):
    _, tcfg, _, model = setup
    ops = model.fused_operands(tcfg)
    in8 = torch.zeros(4, tf.IN8_W, device="meta")
    g = torch.zeros(4, tf.OUT_W, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_mlp_backward(ops, in8, g)
