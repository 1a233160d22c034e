"""The whole eval-mode render slice of the PyTorch port against the JAX
package: ``render_rays`` / ``render_rays_chunked`` at 8x256, C=7,
64 + 128 samples, 32 rays with a chunk that forces padding.

Tolerances:

- unfused fp32: every coarse and fine map at atol 1e-4 (the maps sum 64
  or 192 fp32 terms in another order; the fine depths pass through
  ``sample_pdf``, see ``test_torch_core.py``).  With random importance
  draws (train mode) a draw that lands where a cdf step is within
  rounding of the ``denom < 1e-5`` switch moves its sample by up to a
  bin width in one package and not the other, and that sample's weight
  and its ray's depth with it.  So the fine maps are held by mean |d| /
  max(|ref|, 1) <= 1e-4 and max |d| / max(|ref|, 1) < 1e-2 (observed:
  2e-5 and 2e-3), the coarse maps at atol 1e-4;
- fused bf16 (JAX: Pallas in interpret mode; port: the kernel's plain
  version): coarse maps at max |d| / max(|ref|, 1) < 2e-2, the bound of
  ``tests/test_fused_mlp.py``.  Fine maps by mean |d| <= 1e-2: the
  importance depths come from the coarse weights, so one bf16 ulp of
  difference in sigma moves a few fine samples along their ray and a
  ray's maps with them; the mean bounds that without hiding a
  systematic error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicnerf_tpu.core.losses import semantic_entropy as j_semantic_entropy
from intrinsicnerf_tpu.core.rays import create_rays as j_create_rays
from intrinsicnerf_tpu.models import mlp as jm
from intrinsicnerf_tpu.render import pipeline as jp
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.ops import fused_mlp as tf
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax
from intrinsicnerf_tpu_torch.train.trainer import render_views

MAPS = ("rgb", "disp", "acc", "weights", "depth", "albedo", "shading",
        "residual", "sem_logits")
N_RAYS, CHUNK = 32, 12


def _setup(bf16_fused: bool):
    kw = dict(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=7,
              use_fused_kernel=bf16_fused)
    jcfg = jm.MLPConfig(compute_dtype=jnp.bfloat16 if bf16_fused else jnp.float32, **kw)
    tcfg = tm.MLPConfig(compute_dtype=torch.bfloat16 if bf16_fused else torch.float32, **kw)
    kc, kf = jax.random.split(jax.random.key(11))
    pj = [jax.tree_util.tree_map(np.asarray, jm.init_mlp_params(k, jcfg)) for k in (kc, kf)]
    models = []
    for p in pj:
        m = (tm.PackedMLP if bf16_fused else tm.IntrinsicMLP)(tcfg, device="cpu")
        m.load_state_dict(params_from_jax(p, device="cpu"))
        models.append(m)
    rng = np.random.default_rng(12)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = rng.normal(size=3) * 0.5
    rays = np.asarray(j_create_rays(jnp.asarray(c2w), 4, 8, 6.0, 6.0, 3.5, 1.5, 0.1, 10.0))[0]
    return jcfg, tcfg, pj, models, rays


@pytest.fixture(scope="module")
def unfused():
    return _setup(False)


@pytest.fixture(scope="module")
def fused():
    return _setup(True)


def _maps(res):
    return {lvl: getattr(res, lvl) for lvl in ("coarse", "fine")}


def _compare_all(a, b, atol):
    for lvl, ma in _maps(a).items():
        mb = getattr(b, lvl)
        for name in MAPS:
            np.testing.assert_allclose(
                getattr(mb, name).detach().numpy(), np.asarray(getattr(ma, name)),
                atol=atol, rtol=1e-5, err_msg=f"{lvl}.{name}")


def test_render_rays_chunked_unfused_fp32(unfused):
    jcfg, tcfg, (pc, pf), (mc, mf), rays = unfused
    rcfg_j, rcfg_t = jp.RenderConfig(), tp.RenderConfig()
    a = jp.render_rays_chunked(pc, pf, jcfg, jnp.asarray(rays), rcfg_j, chunk=CHUNK)
    with torch.no_grad():
        b = tp.render_rays_chunked(mc, mf, tcfg, torch.tensor(rays), rcfg_t, chunk=CHUNK)
    assert b.fine.rgb.shape == (N_RAYS, 3) and b.coarse.weights.shape == (N_RAYS, 64)
    assert b.fine.weights.shape == (N_RAYS, 192)
    _compare_all(a, b, 1e-4)
    np.testing.assert_allclose(b.z_std.numpy(), np.asarray(a.z_std), atol=1e-4)


def test_render_rays_train_injected_draws(unfused):
    """Train mode (perturb, sigma noise, random importance draws): the
    JAX key's draws are reproduced and injected into the port."""
    jcfg, tcfg, (pc, pf), (mc, mf), rays = unfused
    rcfg_j = jp.RenderConfig(perturb=1.0, raw_noise_std=1.0, white_bkgd=True)
    rcfg_t = tp.RenderConfig(perturb=1.0, raw_noise_std=1.0, white_bkgd=True)
    key = jax.random.key(5)
    a = jp.render_rays(pc, pf, jcfg, jnp.asarray(rays), key, rcfg_j, train=True)
    kp, knc, kpdf, knf = jax.random.split(key, 4)
    n = rays.shape[0]
    e = -jnp.log1p(-jax.random.uniform(kpdf, (n, 129), dtype=jnp.float32))
    c = jnp.cumsum(e, axis=-1)
    draws = dict(
        t_rand=jax.random.uniform(kp, (n, 64), dtype=jnp.float32),
        noise_c=jax.random.normal(knc, (n, 64)),
        u=c[..., :-1] / c[..., -1:],
        noise_f=jax.random.normal(knf, (n, 192)),
    )
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    with torch.no_grad():
        b = tp.render_rays(mc, mf, tcfg, torch.tensor(rays), rcfg_t, train=True, **draws)
    for name in MAPS:
        np.testing.assert_allclose(
            getattr(b.coarse, name).numpy(), np.asarray(getattr(a.coarse, name)),
            atol=1e-4, rtol=1e-5, err_msg=f"coarse.{name}")
    for name in MAPS:  # a few samples moved at the denom < 1e-5 switch
        x, y = np.asarray(getattr(a.fine, name)), getattr(b.fine, name).numpy()
        scale = max(np.abs(x).max(), 1.0)
        assert np.mean(np.abs(x - y)) / scale <= 1e-4, f"fine.{name}"
        assert np.max(np.abs(x - y)) / scale < 1e-2, f"fine.{name}"
    with pytest.raises(ValueError):
        tp.render_rays(mc, mf, tcfg, torch.tensor(rays), rcfg_t, train=True)


def test_render_rays_chunked_fused_bf16(fused):
    jcfg, tcfg, (pc, pf), (mc, mf), rays = fused
    a = jp.render_rays_chunked(pc, pf, jcfg, jnp.asarray(rays), jp.RenderConfig(), chunk=CHUNK)
    before = tf.fused_mlp_forward.launches
    with torch.no_grad():
        b = tp.render_rays_chunked(mc, mf, tcfg, torch.tensor(rays), tp.RenderConfig(),
                                   chunk=CHUNK)
    assert tf.fused_mlp_forward.launches == before  # CPU: plain version
    for name in MAPS:
        x, y = np.asarray(getattr(a.coarse, name)), getattr(b.coarse, name).numpy()
        assert np.max(np.abs(x - y)) / max(np.abs(x).max(), 1.0) < 2e-2, f"coarse.{name}"
        x, y = np.asarray(getattr(a.fine, name)), getattr(b.fine, name).numpy()
        assert np.mean(np.abs(x - y)) <= 1e-2, f"fine.{name}"


def test_render_views_matches_jax_maps(unfused):
    """The view renderer's numpy maps are the chunked render's fine maps
    reshaped to the image, plus the semantic argmax and entropy (fp32,
    atol 1e-4 as above)."""
    jcfg, tcfg, (pc, pf), (mc, mf), rays = unfused
    h, w = 4, 8
    a = jp.render_rays_chunked(pc, pf, jcfg, jnp.asarray(rays), jp.RenderConfig(), chunk=CHUNK)
    views = list(render_views(mc, mf, tcfg, tp.RenderConfig(), np.stack([rays, rays[::-1]]),
                              h, w, CHUNK, device="cpu"))
    assert len(views) == 2
    v = views[0]
    assert set(v) == {"rgb", "disp", "depth", "acc", "albedo", "shading", "residual",
                      "sem_label", "sem_entropy"}
    for name, shape in (("rgb", (h, w, 3)), ("disp", (h, w)), ("depth", (h, w)),
                        ("acc", (h, w)), ("albedo", (h, w, 3)), ("shading", (h, w)),
                        ("residual", (h, w, 3))):
        ref = np.asarray(getattr(a.fine, name)).reshape(shape)
        np.testing.assert_allclose(v[name], ref, atol=1e-4, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(views[1][name], ref.reshape(h * w, -1)[::-1].reshape(shape),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
    ent = np.asarray(j_semantic_entropy(a.fine.sem_logits)).reshape(h, w)
    np.testing.assert_allclose(v["sem_entropy"], ent, atol=1e-4)
    label = np.asarray(jnp.argmax(a.fine.sem_logits, axis=-1)).reshape(h, w)
    np.testing.assert_array_equal(v["sem_label"], label)


def test_coarse_only(unfused):
    jcfg, tcfg, (pc, _), (mc, _), rays = unfused
    rcfg_t = dataclasses.replace(tp.RenderConfig(), n_importance=0)
    with torch.no_grad():
        b = tp.render_rays_chunked(mc, None, tcfg, torch.tensor(rays), rcfg_t, chunk=CHUNK)
    a = jp.render_rays_chunked(pc, None, jcfg, jnp.asarray(rays),
                               dataclasses.replace(jp.RenderConfig(), n_importance=0),
                               chunk=CHUNK)
    assert b.fine is None and b.z_std is None
    np.testing.assert_allclose(b.coarse.rgb.numpy(), np.asarray(a.coarse.rgb), atol=1e-4)
