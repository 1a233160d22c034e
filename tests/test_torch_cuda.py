"""The port's CUDA kernel on the card, against its plain PyTorch version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel has no CPU
mode); without one they skip.  On a GPU machine, from the repo root
(``--noconftest``: the shared conftest imports JAX, which the port's
machine need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: per output slice max |d| / max(|plain|, 1) < 2e-2, the bound
of ``tests/test_fused_mlp.py``; both sides round the same operands to
bf16, so the observed error is bf16 output rounding (~1e-3).
"""

import pytest
import torch

from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays_chunked

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
