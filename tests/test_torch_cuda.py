"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode); without one they skip.  On a GPU machine, from the repo root
(``--noconftest``: the shared conftest imports JAX, which the port's
machine need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances, those of ``tests/test_fused_mlp.py``:

- kernel 1: per output slice max |d| / max(|plain|, 1) < 2e-2; both sides
  round the same operands to bf16, so the observed error is bf16 output
  rounding (~1e-3);
- kernel 2: over the real parameter slots, overall and per block, cosine
  > 0.999 and max |d| <= 1e-2 * max |plain|, for the cotangent of a
  seeded squared-error loss on the output (coherent across points, as a
  training loss's is); two launches give bitwise-equal gradients.
- kernel 3 (the forward probe): max |d| / max(|plain|, 1) < 2e-2, the
  bound ``chip_smoke.py`` holds it to; both sides round the same operands
  to bf16, and a fp32 sum-order flip of an intermediate bf16 rounding
  moves an output by ~1e-3 at most.
"""

import pytest
import torch

from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table
from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.ops import fwd_probe as fp
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays_chunked
from intrinsicnerf_tpu_torch.train.step import (
    DataPools, TrainConfig, create_train_state, make_train_step)

pytestmark = pytest.mark.cuda

C = 27
SLICES = ((0, 1), (1, 4), (4, 5), (5, 8), (8, 8 + C), (8 + C, fm.OUT_W))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(card):
    cfg = MLPConfig(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=C,
                    compute_dtype=torch.bfloat16, use_fused_kernel=True)
    return cfg, IntrinsicMLP(cfg, device=card, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 20_003])
def test_kernel_matches_plain(model, n):
    cfg, m = model
    g = torch.Generator(device="cuda").manual_seed(n)
    pts = torch.randn(n, 1, 3, device="cuda", generator=g) * 4
    d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda", generator=g), dim=-1)
    ops = m.fused_operands(cfg)
    in8 = fm.build_in8(pts, d)
    before = fm.fused_mlp_forward.launches
    got = fm.fused_mlp_forward(ops, in8)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == before + 1
    ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8)
    assert got.shape == (n, fm.OUT_W) and got.dtype == torch.bfloat16
    for a, b in SLICES:
        x, y = got[:, a:b].float(), ref[:, a:b].float()
        assert (x - y).abs().max().item() / max(y.abs().max().item(), 1.0) < 2e-2, (a, b)


def test_render_goes_through_kernel(model):
    """Eval render on the card: 2 launches per chunk (coarse + fine), and
    coarse maps that agree with the plain version on the host."""
    cfg, m = model
    c2w = torch.eye(4, device="cuda")
    c2w[2, 3] = -1.0
    rays = create_rays(c2w, 12, 16, 8.0, 8.0, 7.5, 5.5, 0.1, 10.0)[0]
    rcfg = RenderConfig()
    before = fm.fused_mlp_forward.launches
    with torch.no_grad():
        out = render_rays_chunked(m, m, cfg, rays, rcfg, chunk=64)
        host = IntrinsicMLP(cfg, device="cpu")
        host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        ref = render_rays_chunked(host, host, cfg, rays.cpu(), rcfg, chunk=64)
    assert fm.fused_mlp_forward.launches == before + 2 * 3
    for name in ("rgb", "depth", "albedo", "sem_logits"):
        x, y = getattr(out.coarse, name).float().cpu(), getattr(ref.coarse, name)
        assert (x - y).abs().max().item() / max(y.abs().max().item(), 1.0) < 2e-2, name
        assert torch.isfinite(getattr(out.fine, name)).all()


def _in8(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.randn(n, 1, 3, device="cuda", generator=g) * 4
    d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda", generator=g), dim=-1)
    return fm.build_in8(pts, d), g


def _cos_rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm())), float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("n", [65_536, 196_608, 100_003])
def test_backward_kernel_matches_plain_and_is_deterministic(model, n):
    """Kernel 2 at the training step's coarse and fine sizes and a ragged
    size, against its plain version; and bitwise equal across launches."""
    cfg, m = model
    ops = m.fused_operands(cfg)
    in8, gen = _in8(n, n)
    out = fm.fused_mlp_forward(ops, in8)
    target = torch.rand(out.shape, device="cuda", generator=gen)
    g = (out.float() - target) / n
    g[:, 8 + C:] = 0.0
    g = g.to(torch.bfloat16)
    before = fm.fused_mlp_backward.launches
    got = fm.fused_mlp_backward(ops, in8, g)
    again = fm.fused_mlp_backward(ops, in8, g)
    torch.cuda.synchronize()
    assert fm.fused_mlp_backward.launches == before + 2
    assert all(torch.equal(got[k], again[k]) for k in got)
    ref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
    masks = fm.packed_grad_masks(dict(m.named_parameters()), cfg)
    keys = [k for k in ref if float((ref[k] * masks[k]).abs().max()) > 0]
    cos, rel = _cos_rel(torch.cat([(got[k] * masks[k]).flatten() for k in keys]),
                        torch.cat([(ref[k] * masks[k]).flatten() for k in keys]))
    assert cos > 0.999 and rel <= 1e-2, (cos, rel)
    for k in keys:
        cos, rel = _cos_rel(got[k] * masks[k], ref[k] * masks[k])
        assert cos > 0.999 and rel <= 1e-2, (k, cos, rel)


def test_training_step_on_card(model):
    """One Replica-width training step on the card: two launches of each
    kernel, every loss term finite, every parameter given a gradient."""
    cfg, _ = model
    h, w = 24, 32
    c2w = torch.eye(4, device="cuda").repeat(2, 1, 1)
    c2w[:, 2, 3] = torch.tensor([-1.0, -1.3])
    rays = create_rays(c2w, h, w, 16.0, 16.0, 15.5, 11.5, 0.1, 10.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pools = DataPools(rays=rays, rgb=torch.rand(2, h * w, 3, device="cuda", generator=gen),
                      semantic=torch.randint(0, C + 1, (2, h * w), device="cuda", generator=gen),
                      mask_ids=torch.ones(2, dtype=torch.int32, device="cuda"))
    tcfg = TrainConfig(n_rays=128)
    state = create_train_state(cfg, tcfg, device="cuda")
    step = make_train_step(cfg, RenderConfig(perturb=1.0, raw_noise_std=1.0), tcfg, h, w)
    before = (fm.fused_mlp_forward.launches, fm.fused_mlp_backward.launches)
    rep = step(state, pools, empty_cluster_table(C, 64, device="cuda"), 0.1, gen)
    torch.cuda.synchronize()
    assert (fm.fused_mlp_forward.launches, fm.fused_mlp_backward.launches) == (
        before[0] + 2, before[1] + 2)
    assert all(torch.isfinite(v) for v in rep), rep
    for mdl in (state.model_coarse, state.model_fine):
        for name, p in mdl.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("variant,n_layers,tile,out,n", [
    *[(v, 8, 64, torch.bfloat16, 20_003) for v in fp.VARIANTS],
    ("full", 1, 32, torch.bfloat16, 4_096), ("full", 16, 128, torch.bfloat16, 4_097),
    ("full", 8, 64, torch.float32, 65), ("nobias", 2, 128, torch.float32, 1),
])
def test_probe_kernel_matches_plain(card, variant, n_layers, tile, out, n):
    """Kernel 3 against its plain version, with nonzero biases, at ragged
    sizes, every variant, each tile and both output types."""
    in8, ops = fp.probe_inputs(n_layers, n=n, bias_scale=0.1, device=card)
    before = fp.fwd_probe.launches
    got = fp.fwd_probe(in8, ops, variant, tile, out)
    torch.cuda.synchronize()
    assert fp.fwd_probe.launches == before + 1
    ref = fp.fwd_probe_plain(in8, ops, variant, out)
    assert got.dtype == out and got.shape == (n, fp.OUT_W)
    err = (got.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(), 1.0)
    assert err < 2e-2, err
