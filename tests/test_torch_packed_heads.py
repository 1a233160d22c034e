"""The fused MLP's heads (``ops/fused_mlp.py:PackedHeads``) on CPU tensors.

``PackedHeads`` turns kernel 1's packed bf16 output ``[P, 128]`` into the
heads ``RawOutputs`` carries and writes the output's bf16 cotangent once;
on CPU tensors its plain versions run.  Each case holds it, bitwise, to
the eager expressions it replaced: the output cast to fp32 and cut into
five slices, whose gradients autograd zero-fills, sums and casts back to
bf16.  The cases: 27 classes and none, every head's gradient present or
some absent (``None`` in the backward), and ``fused_eval_points`` on the
CPU against the same expressions over ``fused_mlp_apply(...).float()``, values and
parameter gradients.  The kernels themselves are held to the same
expressions on the card in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from intrinsicnerf_tpu_torch.core.compositing import RawOutputs
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

HEADS = ("sigma", "albedo", "shading", "residual", "rgb", "sem")


def _eager_heads(out, n, s, c):
    """The heads as ``fused_eval_points`` formed them before the kernels:
    slices of the fp32 copy of the packed output."""
    o = out.float().reshape(n, s, fm.OUT_W)
    albedo = torch.sigmoid(o[..., 1:4])
    shading = torch.sigmoid(o[..., 4])
    residual = torch.sigmoid(o[..., 5:8])
    return (o[..., 0], albedo, shading, residual, albedo * shading[..., None] + residual,
            o[..., 8 : 8 + c])


def _packed_output(n, s, c, seed):
    g = torch.Generator().manual_seed(seed)
    out = torch.randn(n * s, fm.OUT_W, generator=g) * 3
    out[:, 8 + c :] = 0.0  # kernel 1 writes zero past the classes
    return out.to(torch.bfloat16)


def _heads_case(c, absent):
    n, s = 7, 13
    out = _packed_output(n, s, c, 3 + c)
    used = [h for h in HEADS if h not in absent and not (h == "sem" and c == 0)]
    g = torch.Generator().manual_seed(11)

    ref_in = out.clone().requires_grad_(True)
    ref = dict(zip(HEADS, _eager_heads(ref_in, n, s, c)))
    grads = {h: torch.randn(ref[h].shape, generator=g) for h in used}
    torch.autograd.backward([ref[h] for h in used], [grads[h] for h in used])

    got_in = out.clone().requires_grad_(True)
    before = (fm.packed_heads_forward.launches, fm.packed_heads_backward.launches)
    got = dict(zip(HEADS, fm.PackedHeads.apply(got_in, n, s, c)))
    torch.autograd.backward([got[h] for h in used], [grads[h] for h in used])

    for h in HEADS:
        assert got[h].shape == ref[h].shape and got[h].is_contiguous(), h
        assert torch.equal(got[h], ref[h]), h
    assert got_in.grad.dtype == ref_in.grad.dtype == torch.bfloat16
    assert torch.equal(got_in.grad.view(torch.int16), ref_in.grad.view(torch.int16))
    assert not got_in.grad[:, 8 + c :].any()
    assert (fm.packed_heads_forward.launches, fm.packed_heads_backward.launches) == before


def _eager_eval_points(params, cfg, pts, viewdirs, pe=None):
    """``fused_eval_points`` as it was before the heads kernels."""
    n, s, _ = pts.shape
    c = cfg.num_semantic_classes
    out = fm.fused_mlp_apply(params, cfg, fm.build_in8(pts, viewdirs), pe).float()
    out = out.reshape(n, s, fm.OUT_W)
    albedo = torch.sigmoid(out[..., 1:4])
    shading = torch.sigmoid(out[..., 4])
    residual = torch.sigmoid(out[..., 5:8])
    return RawOutputs(rgb=albedo * shading[..., None] + residual, sigma=out[..., 0],
                      albedo=albedo, shading=shading, residual=residual,
                      sem_logits=out[..., 8 : 8 + c] if cfg.enable_semantic else None)


def _loss(r: RawOutputs):
    loss = (r.rgb**2).mean() + 0.1 * (r.sigma**2).mean() + (r.albedo * r.residual).mean()
    loss = loss + (r.shading**3).mean()
    return loss + (0.01 * (r.sem_logits**2).mean() if r.sem_logits is not None else 0.0)


def _eval_points_case(c):
    cfg = tm.MLPConfig(pos_scalar_factor=10.0, enable_semantic=c > 0, num_semantic_classes=c,
                       compute_dtype=torch.bfloat16, use_fused_kernel=True)
    model = tm.PackedMLP(cfg, device="cpu", generator=torch.Generator().manual_seed(c))
    g = torch.Generator().manual_seed(5)
    pts = torch.randn(6, 9, 3, generator=g) * 2
    d = torch.nn.functional.normalize(torch.randn(6, 3, generator=g), dim=-1)
    pe = model.pe_constants(cfg)
    results = []
    for fn in (_eager_eval_points, fm.fused_eval_points):
        model.zero_grad(set_to_none=True)
        r = fn(model.flat(), cfg, pts, d, pe=pe)
        _loss(r).backward()
        results.append((r, model.weight.grad.clone(), model.bias.grad.clone()))
        with torch.no_grad():  # the serving path: kernel 1's operands, no gradient
            served = fn(model.fused_operands(cfg), cfg, pts, d)
        for name in RawOutputs._fields:
            a, b = getattr(r, name), getattr(served, name)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    (ref, dw_ref, db_ref), (got, dw, db) = results
    for name in RawOutputs._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name
    assert torch.equal(dw, dw_ref) and torch.equal(db, db_ref)
    assert dw.abs().max() > 0


CASES = [
    ("heads", 27, ()),
    ("heads", 0, ()),
    ("heads", 27, ("rgb",)),
    ("heads", 27, ("albedo", "shading", "sem")),
    ("heads", 0, ("sigma", "residual", "rgb")),
    ("heads", 27, ("sigma", "albedo", "shading", "residual", "rgb")),
    ("eval_points", 27, ()),
    ("eval_points", 0, ()),
]


@pytest.mark.parametrize("kind,c,absent", CASES,
                         ids=[f"{k}-C{c}" + "".join(f"-no_{h}" for h in a) for k, c, a in CASES])
def test_packed_heads_match_the_eager_expressions(kind, c, absent):
    """Values bitwise, and the bf16 cotangent (or the parameters'
    gradients through kernel 2's plain version) bitwise, against the eager
    expressions; the CPU launches no kernel."""
    if kind == "heads":
        _heads_case(c, absent)
    else:
        _eval_points_case(c)
