"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode); without one they skip.  On a GPU machine, from the repo root
(``--noconftest``: the shared conftest imports JAX, which the port's
machine need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances, those of ``tests/test_fused_mlp.py``:

- kernel 1: per output slice max |d| / max(|plain|, 1) < 2e-2; both sides
  round the same operands to bf16, so the observed error is bf16 output
  rounding (~1e-3); two launches give bitwise-equal outputs, and its
  weight image on the card equals the plain version's byte for byte;
- kernel 2: over the real parameter slots, overall and per block, cosine
  > 0.999 and max |d| <= 1e-2 * max |plain|, for the cotangent of a
  seeded squared-error loss on the output (coherent across points, as a
  training loss's is); two launches give bitwise-equal gradients.
- kernel 3 (the forward probe): max |d| / max(|plain|, 1) < 2e-2, the
  bound ``chip_smoke.py`` holds it to; both sides round the same operands
  to bf16, and a fp32 sum-order flip of an intermediate bf16 rounding
  moves an output by ~1e-3 at most; two launches give bitwise-equal
  outputs, and its weight image on the card equals the plain version's
  byte for byte.
- the object configuration (``configs/object/lego.txt``: the semantic
  head off): kernel 1's semantic and padding columns exactly 0; kernel 2
  at the lego step's fine call (2,048 rays x 192 samples = 393,216
  points) against its plain version at kernel 2's bounds, bitwise across
  launches, its semantic blocks' gradients exactly 0 after the mask
  projection;
- K training steps as one CUDA graph replay (``make_multi_step``) against
  the same K steps run eagerly from the same state and generator state:
  bitwise where two eager runs are bitwise, else the JAX scan test's
  bounds (``tests/test_train_step.py``: the total within rtol 1e-6, every
  parameter within atol 1e-6 + rtol 1e-5); the generator's state equal.
"""

import pytest
import torch

from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table, map_drgb, table_from_numpy
from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.ops import fwd_probe as fp
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays_chunked
from intrinsicnerf_tpu_torch.train.step import (
    DataPools, TrainConfig, create_train_state, make_multi_step, make_train_step, restore_state,
    snapshot_state)

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


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4_097, 20_003, 65_536, 100_003, 196_608])
def test_kernel_matches_plain(model, n):
    """Kernel 1 below, at and past one 64-point tile, at ragged counts and
    at the training step's coarse and fine sizes, against its plain
    version; and bitwise equal across launches."""
    cfg, m = model
    g = torch.Generator(device="cuda").manual_seed(n)
    pts = torch.randn(n, 1, 3, device="cuda", generator=g) * 4
    d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda", generator=g), dim=-1)
    ops = m.fused_operands(cfg)
    in8 = fm.build_in8(pts, d)
    before = fm.fused_mlp_forward.launches
    got = fm.fused_mlp_forward(ops, in8)
    again = fm.fused_mlp_forward(ops, in8)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == before + 2
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8)
    assert got.shape == (n, fm.OUT_W) and got.dtype == torch.bfloat16
    for a, b in SLICES:
        x, y = got[:, a:b].float(), ref[:, a:b].float()
        assert (x - y).abs().max().item() / max(y.abs().max().item(), 1.0) < 2e-2, (a, b)


def test_weight_image_matches_plain(model):
    """Kernel 1's weight image built on the card, byte for byte against the
    plain version's, and the one the model keeps with its operands."""
    cfg, m = model
    ops = m.fused_operands(cfg)
    before = fm.fwd_weight_image.launches
    img = fm.fwd_weight_image(ops.wbuf)
    torch.cuda.synchronize()
    assert fm.fwd_weight_image.launches == before + 1
    want = fm.fwd_weight_image_plain(ops.wbuf).view(torch.int16)
    assert torch.equal(img.view(torch.int16), want)
    assert torch.equal(ops.wimg.view(torch.int16), want)


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


@pytest.mark.parametrize("n", [1, 64, 4_097, 65_536, 196_608, 100_003])
def test_backward_kernel_matches_plain_and_is_deterministic(model, n):
    """Kernel 2 below one 64-point tile, at exactly one, at a ragged count
    that leaves a part-filled chunk of the weight products, at the
    training step's coarse and fine sizes and at a ragged step size,
    against its plain version; and bitwise equal across launches."""
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
    ("full", 1, 64, torch.bfloat16, 4_096), ("full", 16, 128, torch.bfloat16, 4_097),
    ("full", 8, 64, torch.float32, 65), ("nobias", 2, 128, torch.float32, 1),
    ("full", 8, 128, torch.bfloat16, 1), ("norelu", 8, 128, torch.float32, 64),
    ("nope", 4, 128, torch.bfloat16, 4_097),
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


@pytest.mark.parametrize("tile", fp.TILES)
def test_probe_kernel_is_deterministic(card, tile):
    """Two launches of kernel 3 on the same inputs give bitwise-equal outputs."""
    in8, ops = fp.probe_inputs(8, n=20_003, bias_scale=0.1, device=card)
    got = fp.fwd_probe(in8, ops, "full", tile, torch.float32)
    again = fp.fwd_probe(in8, ops, "full", tile, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("n_layers", [1, 8, fp.MAX_LAYERS])
def test_probe_weight_image_matches_plain(card, n_layers):
    """Kernel 3's weight image built on the card, byte for byte against the
    plain version's, and the one ``probe_operands`` keeps."""
    _, ops = fp.probe_inputs(n_layers, n=1, device=card)
    before = fp.fwd_probe_image.launches
    img = fp.fwd_probe_image(ops.wbuf, n_layers)
    torch.cuda.synchronize()
    assert fp.fwd_probe_image.launches == before + 1
    want = fp.probe_weight_image_plain(ops.wbuf, n_layers).view(torch.int16)
    assert torch.equal(img.view(torch.int16), want)
    assert torch.equal(ops.wimg.view(torch.int16), want)


# ---- K steps per call as one CUDA graph -------------------------------

GRAPH_K = 4


@pytest.fixture
def graph_setup(model):
    """A Replica-width step on two small synthetic views, a state after one
    eager step (Adam's state made) and its snapshot."""
    cfg, _ = model
    h, w = 24, 32
    c2w = torch.eye(4, device="cuda").repeat(2, 1, 1)
    c2w[:, 2, 3] = torch.tensor([-1.0, -1.3])
    rays = create_rays(c2w, h, w, 16.0, 16.0, 15.5, 11.5, 0.1, 10.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pools = DataPools(rays=rays, rgb=torch.rand(2, h * w, 3, device="cuda", generator=gen),
                      semantic=torch.randint(0, C + 1, (2, h * w), device="cuda", generator=gen),
                      mask_ids=torch.ones(2, dtype=torch.int32, device="cuda"))
    tcfg = TrainConfig(n_rays=128)
    state = create_train_state(cfg, tcfg, device="cuda")
    step = make_train_step(cfg, RenderConfig(perturb=1.0, raw_noise_std=1.0), tcfg, h, w)
    table = empty_cluster_table(C, 64, device="cuda")
    w_c = torch.tensor(0.1, device="cuda")
    step(state, pools, table, w_c, gen)
    return step, state, pools, table, w_c, gen, snapshot_state(state, gen)


def _run(state, snap, gen, fn):
    restore_state(state, snap, gen)
    report = fn()
    torch.cuda.synchronize()
    params = [p.detach().clone() for g in state.optimizer.param_groups for p in g["params"]]
    return report, params, gen.get_state()


def _agree(a, b, exact):
    (ra, pa, ga), (rb, pb, gb) = a, b
    if not torch.equal(ga, gb):
        return False
    if exact:
        return all(torch.equal(x, y) for x, y in zip(ra, rb)) and all(
            torch.equal(x, y) for x, y in zip(pa, pb))
    return (abs(float(ra.total) - float(rb.total)) <= 1e-6 * abs(float(rb.total))
            and all(torch.allclose(x, y, rtol=1e-5, atol=1e-6) for x, y in zip(pa, pb)))


def test_graphed_steps_equal_eager_steps(graph_setup):
    """K steps as one replay equal K eager steps from the same state and
    generator state; the kernels were recorded into the graph 2K times;
    a replay bumps the parameters' versions, so the model's packed
    operands are made anew."""
    step, state, pools, table, w_c, gen, snap = graph_setup

    def eager():
        for _ in range(GRAPH_K):
            rep = step(state, pools, table, w_c, gen)
        return rep

    first, second = _run(state, snap, gen, eager), _run(state, snap, gen, eager)
    exact = _agree(first, second, True)
    multi = make_multi_step(step, GRAPH_K)
    before = (fm.fused_mlp_forward.captured, fm.fused_mlp_backward.captured)
    graphed = _run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen))
    assert (fm.fused_mlp_forward.captured, fm.fused_mlp_backward.captured) == (
        before[0] + 2 * GRAPH_K, before[1] + 2 * GRAPH_K)
    assert multi.replays == 1 and state.step == snap["step"] + GRAPH_K
    assert int(state.step_t) == state.step
    assert _agree(graphed, first, exact)
    assert _agree(_run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen)), first,
                  exact)
    # the replay wrote the parameters: the model's packed operands follow
    ops = state.model_fine.fused_operands(state.model_fine.cfg)
    fine = [p.detach().clone() for p in state.model_fine.parameters()]
    multi(state, pools, table, w_c, gen)
    assert state.model_fine.fused_operands(state.model_fine.cfg) is not ops
    assert not all(torch.equal(a, p) for a, p in zip(fine, state.model_fine.parameters()))


def test_generator_advances_across_replays(graph_setup):
    """Each replay draws new rays and noise: two replays leave the generator
    where 2K eager steps leave it, with different losses from each."""
    step, state, pools, table, w_c, gen, snap = graph_setup
    multi = make_multi_step(step, GRAPH_K)
    restore_state(state, snap, gen)
    r1 = multi(state, pools, table, w_c, gen)
    after_one = gen.get_state()
    r2 = multi(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    after_two = gen.get_state()
    assert not torch.equal(after_one, after_two) and float(r1.total) != float(r2.total)
    restore_state(state, snap, gen)
    for _ in range(2 * GRAPH_K):
        step(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    assert torch.equal(gen.get_state(), after_two)


def test_graph_reads_a_table_copied_in(graph_setup):
    """A graph captured on one table reads a new one copied into its
    tensors, and the ``w_c`` copied into its tensor: its replay equals the
    eager steps on the new table, not those on the old."""
    step, state, pools, table, w_c, gen, snap = graph_setup
    multi = make_multi_step(step, GRAPH_K)
    _run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen))  # captured on the empty table
    g = torch.Generator().manual_seed(2)
    per_class = []
    for _ in range(C):
        centers = torch.rand(4, 3, generator=g).numpy()
        links = torch.randint(0, 4, (64,), generator=g).numpy()
        per_class.append((map_drgb(centers[links]), links, centers))
    new = table_from_numpy(per_class, 64, device="cuda")
    old = [t.clone() for t in table[:4]]
    for buf, t in zip(table[:4], new[:4]):
        buf.copy_(t)
    w_c.fill_(1.0)

    def eager(tab):
        def fn():
            for _ in range(GRAPH_K):
                rep = step(state, pools, tab, w_c, gen)
            return rep
        return fn

    graphed = _run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen))
    on_new = _run(state, snap, gen, eager(new))
    on_old = _run(state, snap, gen, eager(table._replace(
        anchors=old[0], colors=old[1], links=old[2], has_cluster=old[3])))
    exact = _agree(_run(state, snap, gen, eager(new)), on_new, True)
    assert _agree(graphed, on_new, exact)
    assert not _agree(graphed, on_old, False)


# ---- the object configuration (semantic head off) ----------------------


@pytest.fixture(scope="module")
def object_model(card):
    cfg = MLPConfig(pos_scalar_factor=1.0, enable_semantic=False, compute_dtype=torch.bfloat16,
                    use_fused_kernel=True)
    return cfg, IntrinsicMLP(cfg, device=card, generator=torch.Generator().manual_seed(1))


def test_object_kernel_semantic_columns_are_zero(object_model):
    """With the semantic head off the pack fills its blocks with zeros;
    kernel 1 still runs that block, and its output columns 8 and up must
    come out exactly 0, the real columns within kernel 1's bound."""
    cfg, m = object_model
    in8, _ = _in8(131_072, 3)  # the lego step's coarse call: 2,048 rays x 64 samples
    ops = m.fused_operands(cfg)
    got = fm.fused_mlp_forward(ops, in8)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 8:], torch.zeros_like(got[:, 8:]))
    ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8)
    for a, b in SLICES[:4]:
        x, y = got[:, a:b].float(), ref[:, a:b].float()
        assert (x - y).abs().max().item() / max(y.abs().max().item(), 1.0) < 2e-2, (a, b)


def test_object_backward_at_the_fine_step(object_model):
    """Kernel 2 at the lego step's fine call (393,216 points, twice the
    largest Replica call) against its plain version, bitwise across
    launches; the zero semantic blocks get an exactly zero gradient, and
    the mask projection keeps the summed output bias's share (``b_m2``)
    from any parameter."""
    cfg, m = object_model
    n = 393_216
    ops = m.fused_operands(cfg)
    in8, gen = _in8(n, 4)
    out = fm.fused_mlp_forward(ops, in8)
    g = (out.float() - torch.rand(out.shape, device="cuda", generator=gen)) / n
    g[:, 8:] = 0.0  # the object model reads sigma, albedo, shading and residual
    g = g.to(torch.bfloat16)
    got = fm.fused_mlp_backward(ops, in8, g)
    again = fm.fused_mlp_backward(ops, in8, g)
    torch.cuda.synchronize()
    assert all(torch.equal(got[k], again[k]) for k in got)
    masks = fm.packed_grad_masks(dict(m.named_parameters()), cfg)
    for k in ("w_m1", "b_m1", "w_m2"):
        assert float(got[k].abs().max()) == 0.0, k
    for k in ("w_m1", "b_m1", "w_m2", "b_m2"):  # b_m2 is a share of the summed output bias
        assert float((got[k] * masks[k]).abs().max()) == 0.0, k
    ref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
    keys = [k for k in ref if float((ref[k] * masks[k]).abs().max()) > 0]
    assert not any(k.endswith(("m1", "m2")) for k in keys)
    cos, rel = _cos_rel(torch.cat([(got[k] * masks[k]).flatten() for k in keys]),
                        torch.cat([(ref[k] * masks[k]).flatten() for k in keys]))
    assert cos > 0.999 and rel <= 1e-2, (cos, rel)
    for k in keys:
        cos, rel = _cos_rel(got[k] * masks[k], ref[k] * masks[k])
        assert cos > 0.999 and rel <= 1e-2, (k, cos, rel)


def test_graphed_object_steps_cross_the_precrop_boundary(object_model):
    """K object steps as one replay, starting K/2 steps before the precrop
    warm-up ends, equal the same K eager steps (bitwise where two eager
    runs are), and differ from K steps whose warm-up never ends: the
    replay's sampler reads the device step counter."""
    import types

    from intrinsicnerf_tpu_torch.data.blender import pose_spherical
    from intrinsicnerf_tpu_torch.core.rays import camera_ray_dirs
    from intrinsicnerf_tpu_torch.train.step import PosePools
    from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, make_object_sample_fn

    cfg, _ = object_model
    h = w = 32
    gen = torch.Generator(device="cuda").manual_seed(5)
    poses = torch.stack([torch.from_numpy(pose_spherical(60.0 * i, -30.0, 4.0))
                         for i in range(3)]).cuda()
    pools = PosePools(dirs_cam=camera_ray_dirs(h, w, 40.0, 40.0, w * 0.5, h * 0.5, "opengl",
                                               device="cuda").reshape(-1, 3),
                      poses=poses, rgb=torch.rand(3, h * w, 3, device="cuda", generator=gen),
                      mask=(torch.rand(3, h * w, device="cuda", generator=gen) > 0.5).float())
    bundle = SceneBundle(pools=pools, rays_vis=None, rays_test=None, h=h, w=w, h_scaled=h,
                         w_scaled=w, num_valid_classes=0)
    tcfg = TrainConfig(n_rays=256, mask_mode="mask", no_semantic_tree=True)
    start = 100
    rcfg = RenderConfig(perturb=1.0, raw_noise_std=0.0, white_bkgd=True)

    def step_for(precrop_iters):
        ocfg = types.SimpleNamespace(depth_range=(2.0, 6.0), train=tcfg,
                                     precrop_iters=precrop_iters, precrop_frac=0.5)
        return make_train_step(cfg, rcfg, tcfg, h, w,
                               sample_fn=make_object_sample_fn(ocfg, bundle))

    step, endless = step_for(start + GRAPH_K // 2), step_for(10 ** 9)
    state = create_train_state(cfg, tcfg, device="cuda")
    table = empty_cluster_table(1, 64, device="cuda")
    w_c = torch.tensor(0.1, device="cuda")
    step(state, pools, table, w_c, gen)  # Adam's state made
    state.step = start
    state.step_t.fill_(start)
    snap = snapshot_state(state, gen)

    def eager(fn):
        def run():
            for _ in range(GRAPH_K):
                rep = fn(state, pools, table, w_c, gen)
            return rep
        return run

    first, second = _run(state, snap, gen, eager(step)), _run(state, snap, gen, eager(step))
    exact = _agree(first, second, True)
    multi = make_multi_step(step, GRAPH_K)
    graphed = _run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen))
    assert int(state.step_t) == state.step == start + GRAPH_K
    assert _agree(graphed, first, exact)
    assert not _agree(graphed, _run(state, snap, gen, eager(endless)), False)


# ---- the other scene data: NYU widths, pixels across all images, mesh -----


@pytest.mark.parametrize("c", [40, 13])
@pytest.mark.parametrize("n", [65_536, 196_608])
def test_kernels_at_nyu_widths(card, c, n):
    """Kernels 1 and 2 at the NYU-40 and NYU-13 semantic widths (ScanNet,
    Replica-NYU) at the step's coarse and fine calls: kernel 1 per output
    slice, the padding columns exactly 0; kernel 2 per block (the output
    block's gradient covers columns 8 to 8 + C); both bitwise across
    launches."""
    cfg = MLPConfig(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=c,
                    compute_dtype=torch.bfloat16, use_fused_kernel=True)
    m = IntrinsicMLP(cfg, device=card, generator=torch.Generator().manual_seed(c))
    ops = m.fused_operands(cfg)
    in8, gen = _in8(n, c + n)
    got = fm.fused_mlp_forward(ops, in8)
    again = fm.fused_mlp_forward(ops, in8)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8)
    for a, b in ((0, 1), (1, 4), (4, 5), (5, 8), (8, 8 + c)):
        x, y = got[:, a:b].float(), ref[:, a:b].float()
        assert (x - y).abs().max().item() / max(y.abs().max().item(), 1.0) < 2e-2, (a, b)
    assert torch.equal(got[:, 8 + c:], torch.zeros_like(got[:, 8 + c:]))
    g = (got.float() - torch.rand(got.shape, device="cuda", generator=gen)) / n
    g[:, 8 + c:] = 0.0
    g = g.to(torch.bfloat16)
    bwd = fm.fused_mlp_backward(ops, in8, g)
    bwd2 = fm.fused_mlp_backward(ops, in8, g)
    torch.cuda.synchronize()
    assert all(torch.equal(bwd[k], bwd2[k]) for k in bwd)
    bref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
    masks = fm.packed_grad_masks(dict(m.named_parameters()), cfg)
    keys = [k for k in bref if float((bref[k] * masks[k]).abs().max()) > 0]
    assert {"w_m1", "b_m1", "w_m2", "b_m2"} <= set(keys)
    assert float(masks["w_m2"][:, 8:8 + c].min()) == 1.0
    for k in keys:
        cos, rel = _cos_rel(bwd[k] * masks[k], bref[k] * masks[k])
        assert cos > 0.999 and rel <= 1e-2, (k, cos, rel)


def test_graphed_all_images_steps_equal_eager_steps(model):
    """K steps drawing each pair's image over the whole training set (the
    ``no_batching: false`` sampler), as one replay, equal the same K eager
    steps from the same state (bitwise where two eager runs are)."""
    from intrinsicnerf_tpu_torch.data.samplers import sample_ray_pairs_all_images

    cfg, _ = model
    h, w, n_img = 24, 32, 3
    c2w = torch.eye(4, device="cuda").repeat(n_img, 1, 1)
    c2w[:, 2, 3] = torch.tensor([-1.0, -1.3, -1.6])
    rays = create_rays(c2w, h, w, 16.0, 16.0, 15.5, 11.5, 0.1, 10.0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    pools = DataPools(rays=rays, rgb=torch.rand(n_img, h * w, 3, device="cuda", generator=gen),
                      depth=torch.rand(n_img, h * w, device="cuda", generator=gen) + 1.0,
                      semantic=torch.randint(0, C + 1, (n_img, h * w), device="cuda",
                                             generator=gen),
                      mask_ids=torch.tensor([1, 0, 1], device="cuda"))
    tcfg = TrainConfig(n_rays=128)

    def sample_fn(generator, p, step):
        return sample_ray_pairs_all_images(generator, p.rays, p.rgb, h, w, tcfg.n_rays,
                                           depth_pool=p.depth, sem_pool=p.semantic,
                                           mask_ids=p.mask_ids)

    state = create_train_state(cfg, tcfg, device="cuda")
    step = make_train_step(cfg, RenderConfig(perturb=1.0, raw_noise_std=1.0), tcfg, h, w,
                           sample_fn=sample_fn)
    table = empty_cluster_table(C, 64, device="cuda")
    w_c = torch.tensor(0.1, device="cuda")
    step(state, pools, table, w_c, gen)
    snap = snapshot_state(state, gen)

    def eager():
        for _ in range(GRAPH_K):
            rep = step(state, pools, table, w_c, gen)
        return rep

    first, second = _run(state, snap, gen, eager), _run(state, snap, gen, eager)
    exact = _agree(first, second, True)
    multi = make_multi_step(step, GRAPH_K)
    assert _agree(_run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen)), first,
                  exact)
    assert multi.replays == 1 and all(torch.isfinite(v) for v in first[0])


def test_density_grid_query_goes_through_kernel_1(model):
    """The mesh's grid query on the card: one kernel-1 launch per chunk,
    occupancy within 2e-2 of the same query through the plain version on
    the host (kernel 1's bound on sigma, carried through
    ``1 - exp(-relu(sigma) * voxel)``, whose slope is at most ``voxel``)."""
    import numpy as np

    from intrinsicnerf_tpu_torch.geometry.mesh import query_density_grid

    cfg, m = model
    pts = np.random.default_rng(6).uniform(-2, 2, size=(300_000, 3)).astype(np.float32)
    before = fm.fused_mlp_forward.launches
    occ, sem = query_density_grid(m, cfg, pts, 0.05, chunk=131_072)
    assert fm.fused_mlp_forward.launches == before + 3
    host = IntrinsicMLP(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    occ_p, _ = query_density_grid(host, cfg, pts[:20_000], 0.05, chunk=131_072)
    assert occ.shape == (300_000,) and sem.shape == (300_000,)
    assert np.abs(occ[:20_000] - occ_p).max() < 2e-2 and np.isfinite(occ).all()
