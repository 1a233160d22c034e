"""The forward-attribution probe (kernel 3's plain version) against the
Pallas probe kernel of ``tools_fwd_probe.py``.

The JAX side is ``tools_fwd_probe.make_kernel`` itself, run through
``pl.pallas_call(..., interpret=True)`` on the CPU (its VMEM memory spaces
dropped: interpret mode has none), at 256 points in tiles of 128.  Both
sides get the same numpy operands, with nonzero biases so the bias path
is seen (``run`` uses zeros).

Bounds, on |d| / max(|ref|, 1):
- bf16 output: max 1e-2.  One bf16 rounding step of the output is 2^-8 =
  3.9e-3 relative; the two sides sum the same exact bf16 products in
  different orders (XLA's and PyTorch's fp32 kernels), which can move a
  value across a rounding boundary.
- fp32 output, one layer: max 1e-4.  Only the order of the fp32 sums
  differs (~1e-7 relative); measured <= 2.4e-6.
- fp32 output, more layers: max 1e-2 and mean 1e-4.  Every layer's input
  is rounded to bf16 on both sides; where the sum order flips that
  rounding (2^-8 of one activation), the change reaches the output
  through the later layers: measured up to 2.9e-3 at 8 layers (norelu),
  on a few hundred of the 32,768 outputs.  Flips are rare, so the mean
  stays small (measured <= 2e-5), while an output rounded to bf16 on one
  side would show in every element.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import tools_fwd_probe as probe_ref
from intrinsicnerf_tpu_torch.ops import fwd_probe as fp

N, TILE = 256, 128
MAX_TOL = {"bf16": 1e-2, "f32": 1e-2, "f32_one_layer": 1e-4}
MEAN_TOL_F32 = 1e-4


def _operands(n_layers, seed):
    rng = np.random.default_rng(seed)
    in8 = rng.normal(size=(N, 8)).astype(np.float32)
    pe = rng.normal(size=(8, fp.IN_W)).astype(np.float32)
    sm = (rng.uniform(size=(1, fp.IN_W)) > 0.3).astype(np.float32)
    shapes = [(fp.IN_W, fp.W)] + [(fp.W, fp.W)] * (n_layers - 1)
    ws = [rng.normal(size=s).astype(np.float32) * 0.05 for s in shapes]
    bs = [rng.normal(size=(1, fp.W)).astype(np.float32) * 0.1 for _ in shapes]
    return in8, pe, sm, ws, bs


def _pallas(in8, pe, sm, ws, bs, variant, out_dtype):
    n_layers = len(ws)

    def rep(shape):
        return pl.BlockSpec(shape, lambda i: tuple(0 for _ in shape))

    f = pl.pallas_call(
        probe_ref.make_kernel(n_layers, variant),
        grid=(N // TILE,),
        in_specs=[pl.BlockSpec((TILE, 8), lambda i: (i, 0)), rep(pe.shape), rep(sm.shape),
                  *[rep(w.shape) for w in ws], *[rep(b.shape) for b in bs]],
        out_specs=pl.BlockSpec((TILE, probe_ref.OUT_W), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, probe_ref.OUT_W), out_dtype),
        interpret=True,
    )
    out = f(*(jnp.asarray(a) for a in (in8, pe, sm, *ws, *bs)))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("n_layers", [1, 2, 8])
@pytest.mark.parametrize("variant", fp.VARIANTS)
def test_plain_matches_pallas_probe(variant, n_layers, out):
    in8, pe, sm, ws, bs = _operands(n_layers, seed=n_layers)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    ref = _pallas(in8, pe, sm, ws, bs, variant, jdt)
    t = torch.from_numpy
    ops = fp.probe_operands(t(pe), t(sm), [t(w) for w in ws], [t(b) for b in bs])
    got = fp.fwd_probe(t(in8), ops, variant, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (N, fp.OUT_W)
    d = np.abs(got.float().numpy() - ref) / max(np.abs(ref).max(), 1.0)
    key = "f32_one_layer" if out == "f32" and n_layers == 1 else out
    assert d.max() < MAX_TOL[key], (variant, n_layers, out, d.max())
    if out == "f32":
        assert d.mean() < MEAN_TOL_F32, (variant, n_layers, d.mean())
        nonzero = got != 0
        # the fp32 output is not bf16 in disguise
        assert (got[nonzero] != got[nonzero].to(torch.bfloat16).float()).float().mean() > 0.5


def test_probe_inputs_are_the_pallas_probes_draws():
    """``probe_inputs`` draws what ``tools_fwd_probe.run`` draws, in order."""
    in8, ops = fp.probe_inputs(2, n=64, device="cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(in8.numpy(), rng.normal(size=(64, 8)).astype(np.float32))
    np.testing.assert_array_equal(ops.pe.numpy(), rng.normal(size=(8, 128)).astype(np.float32))
    sm = (rng.uniform(size=(1, 128)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(ops.sm.numpy(), sm)
    w0 = rng.normal(size=(128, 256)).astype(np.float32) * 0.05
    np.testing.assert_array_equal(
        ops.ws[0].numpy(), torch.from_numpy(w0).to(torch.bfloat16).float().numpy())
    assert all(float(b.abs().max()) == 0.0 for b in ops.bs)  # run's biases are zero
    assert ops.wbuf.dtype == torch.bfloat16 and ops.wbuf.numel() == 128 * 256 + 256 * 256


def test_probe_rejects_bad_arguments():
    in8, ops = fp.probe_inputs(1, n=16, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        fp.fwd_probe(in8, ops, "fast")
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fp.fwd_probe(in8, ops, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="1..16 layers"):
        fp.probe_operands(ops.pe, ops.sm, ops.ws * 17, ops.bs * 17)
    before = fp.fwd_probe.launches
    fp.fwd_probe(in8, ops)  # the plain version: no launch counted
    assert fp.fwd_probe.launches == before


def test_probe_work_counts_the_bound():
    flops, nbytes = fp.probe_work(fp.N_PTS, 8)
    assert flops == 2 * fp.N_PTS * (128 * 256 + 7 * 256 * 256)
    assert abs(flops / 989e12 * 1e3 - 0.1955) < 1e-3  # ms at the bf16 peak
    assert flops / 989e12 > nbytes / 3.35e12  # bound by operations
