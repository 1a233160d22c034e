"""Core-op parity of the PyTorch port against the JAX package (CPU, fp32).

Inputs come from ``numpy.random.default_rng`` and go to both packages;
random draws are injected.  Tolerances: elementwise ops at atol 1e-6
(fp32 transcendental/rounding differences between the two CPU
backends are ~1e-7); ``sample_pdf`` at atol 1e-5 plus rtol 1e-5 (the two
cumsums round differently, and the inverse CDF divides that by the cdf
step, ~30 ulp of depth here).  A tail of zero weights is left out: there
``u = 1`` lands on the last or the second-to-last bin edge depending on
the last ulp of ``cdf[-1]``, in either package.  The merge is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsicnerf_tpu.core import compositing as jc
from intrinsicnerf_tpu.core import pe as jpe
from intrinsicnerf_tpu.core import rays as jr
from intrinsicnerf_tpu.core import sampling as js
from intrinsicnerf_tpu_torch.core import compositing as tc
from intrinsicnerf_tpu_torch.core import pe as tpe
from intrinsicnerf_tpu_torch.core import rays as tr
from intrinsicnerf_tpu_torch.core import sampling as ts


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol, rtol=rtol)


@pytest.mark.parametrize("scale", [1.0, 10.0])
@pytest.mark.parametrize("n_freqs", [0, 4, 10])
def test_positional_encoding(scale, n_freqs):
    x = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32) * 3
    a = jpe.positional_encoding(jnp.asarray(x), n_freqs, scalar_factor=scale)
    b = tpe.positional_encoding(_t(x), n_freqs, scalar_factor=scale)
    assert b.shape[-1] == tpe.pe_output_dim(n_freqs) == jpe.pe_output_dim(n_freqs)
    _close(a, b, 1e-6)


def _c2w(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q
    m[:3, 3] = rng.normal(size=3)
    return m.astype(np.float32)


@pytest.mark.parametrize("convention", ["opencv", "opengl"])
@pytest.mark.parametrize("euclid", [False, True])
def test_create_rays(convention, euclid):
    rng = np.random.default_rng(1)
    c2w = np.stack([_c2w(rng), _c2w(rng)])
    args = (6, 9, 7.5, 8.0, 4.0, 2.5, 0.1, 10.0, convention, euclid)
    a = jr.create_rays(jnp.asarray(c2w), *args)
    b = tr.create_rays(_t(c2w), *args)
    assert tuple(b.shape) == (2, 54, 11)
    _close(a, b, 1e-6)


def test_ndc_rays():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(40, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5  # forward-facing (opengl -z)
    a = jr.ndc_rays(24, 32, 30.0, 1.0, jnp.asarray(o), jnp.asarray(d))
    b = tr.ndc_rays(24, 32, 30.0, 1.0, _t(o), _t(d))
    for x, y in zip(a, b):
        _close(x, y, 1e-6, 1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_and_perturb(lindisp):
    rng = np.random.default_rng(3)
    near = rng.uniform(0.1, 1.0, size=(9, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 9.0, size=(9, 1)).astype(np.float32)
    a = js.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 64, lindisp)
    b = ts.stratified_z_vals(_t(near), _t(far), 64, lindisp)
    _close(a, b, 1e-6)
    key = jax.random.key(7)
    t_rand = np.asarray(jax.random.uniform(key, a.shape, dtype=a.dtype))
    _close(js.perturb_z_vals(a, key), ts.perturb_z_vals(b, _t(t_rand)), 1e-6)


def _pdf_inputs(rng, n=11, nb=63):
    bins = np.sort(rng.uniform(0.5, 8.0, size=(n, nb)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(n, nb - 1)).astype(np.float32)
    w[0] = 0.0  # all-zero weights: uniform pdf via the +1e-5
    w[1, 10:30] = 0.0  # a plateau of 1e-5 steps (the denom < 1e-5 rule)
    return bins, w


def test_sample_pdf_det():
    bins, w = _pdf_inputs(np.random.default_rng(4))
    a = js.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, det=True)
    b = ts.sample_pdf(_t(bins), _t(w), 128, det=True)
    _close(a, b, 1e-5, 1e-5)


def test_sample_pdf_injected_u():
    rng = np.random.default_rng(5)
    bins, w = _pdf_inputs(rng)
    u = np.sort(rng.uniform(size=(bins.shape[0], 128)), axis=-1).astype(np.float32)
    a = js.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, u=jnp.asarray(u))
    b = ts.sample_pdf(_t(bins), _t(w), 128, u=_t(u))
    _close(a, b, 1e-5, 1e-5)
    with pytest.raises(ValueError):
        ts.sample_pdf(_t(bins), _t(w), 128, det=False)


def test_merge_is_exact():
    rng = np.random.default_rng(6)
    a = np.sort(rng.uniform(0, 5, size=(13, 64)), axis=-1).astype(np.float32)
    b = np.sort(rng.uniform(0, 5, size=(13, 128)), axis=-1).astype(np.float32)
    b[0, :5] = a[0, 3]  # ties between the operands
    ref = np.asarray(js.merge_sorted_z_vals(jnp.asarray(a), jnp.asarray(b)))
    got = ts.merge_z_vals(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("with_noise", [False, True])
def test_composite(white_bkgd, with_noise):
    rng = np.random.default_rng(8)
    n, s, c = 10, 24, 5
    z = np.sort(rng.uniform(0.1, 6.0, size=(n, s)), axis=-1).astype(np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    sigma = rng.normal(size=(n, s)).astype(np.float32) * 3
    sigma[0] = 0.0  # acc == 0 ray: finite disp
    f = lambda *shape: rng.uniform(size=shape).astype(np.float32)  # noqa: E731
    fields = dict(
        rgb=f(n, s, 3), sigma=sigma, albedo=f(n, s, 3), shading=f(n, s),
        residual=f(n, s, 3), sem_logits=rng.normal(size=(n, s, c)).astype(np.float32),
    )
    noise = -np.abs(rng.normal(size=(n, s))).astype(np.float32) if with_noise else None
    a = jc.composite(
        jc.RawOutputs(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(z), jnp.asarray(rays_d),
        None if noise is None else jnp.asarray(noise), white_bkgd,
    )
    b = tc.composite(
        tc.RawOutputs(**{k: _t(v) for k, v in fields.items()}),
        _t(z), _t(rays_d), None if noise is None else _t(noise), white_bkgd,
    )
    assert float(b.acc[0]) == 0.0 and np.isfinite(b.disp.numpy()).all()
    for name in ("rgb", "disp", "acc", "weights", "depth", "albedo", "shading",
                 "residual", "sem_logits"):
        _close(getattr(a, name), getattr(b, name), 1e-6, 1e-5)
