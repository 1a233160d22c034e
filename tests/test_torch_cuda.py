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
  around the sizes where its persistent schedule changes (n = 1, 64, 65,
  S*64 - 1, S*64, S*64 + 1, 2*S*64 + 37 at the card's S SMs, the step's
  fine call and a view's coarse chunk) the same, with the counters
  ``fwd.tiles`` and ``fwd.tiles_ahead`` moved by ``fwd_schedule``'s
  amounts; a 64-aligned slice's launch, and two replays of a captured
  launch, give bitwise the full or eager launch's rows; its saving
  instance (training) gives bitwise the serving instance's output and
  moves ``fwd.saved_tiles`` by its tiles;
- kernel 2, on the saved forward of kernel 1's saving instance: over the
  real parameter slots, overall and per block, cosine > 0.999 and max |d|
  <= 1e-2 * max |plain|, for the cotangent of a seeded squared-error loss
  on the output (coherent across points, as a training loss's is), at C =
  27 and with the semantic head off; two launches give bitwise-equal
  gradients; a captured saving forward and backward replay bitwise the
  eager ones; each launch moves the counters ``bwd.tiles`` and
  ``bwd.tiles_ahead`` by ``bwd_schedule``'s amounts, and a captured
  training block's backward calls move them by the same at each replay,
  where ``fwd.saved_tiles`` moves as ``bwd.tiles`` does (and not at all
  in a render).
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
  parameter within atol 1e-6 + rtol 1e-5); the generator's state equal;
- the packed training state over graphed steps: its padded slots, in the
  buffers and in Adam's moments, exactly zero after every step;
- 8 forward-facing object steps in NDC as one replay against the same 8
  eager steps: bitwise, with 14 clock stamps a captured step (10 on
  Replica's path);
- the heads' kernels (``csrc/packed_heads.cu``) against the eager
  expressions they replace, run on the card: the heads bitwise; the
  cotangent bitwise but for the shading logit's column, held to one bf16
  ulp (the kernel sums that column's three products in the order ATen's
  reduction was measured to take); a captured replay bitwise the eager
  launches; a graphed step with no fill, sum, copy or cast of the packed
  output's [P, 128].
"""

import math

import pytest
import torch

from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table, map_drgb, table_from_numpy
from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.models.mlp import MLPConfig, PackedMLP
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.ops import fwd_probe as fp
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig, render_rays_chunked
from intrinsicnerf_tpu_torch.train.step import (
    DataPools, TrainConfig, create_train_state, make_multi_step, make_train_step, restore_state,
    snapshot_state)
from intrinsicnerf_tpu_torch.utils import trace

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
    return cfg, PackedMLP(cfg, device=card, generator=torch.Generator().manual_seed(0))


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


def _sms():
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def _tile_counters(kernel="fwd"):
    c = trace.snapshot()["counters"]
    return c.get(f"{kernel}.tiles", 0), c.get(f"{kernel}.tiles_ahead", 0)


# n = k * S * 64 + d, S the card's SM count (132 on the H100): below, at
# and past one tile, ragged counts, the training step's coarse and fine
# calls, a view's coarse chunk; and where the persistent schedule changes:
# a block's second tile (S * 64 + 1), two waves and a ragged tail
KERNEL_CASES = [(0, 1), (0, 63), (0, 64), (0, 65), (0, 1000), (0, 4_097), (0, 20_003),
                (0, 65_536), (0, 100_003), (0, 196_608), (0, 2_097_152),
                (1, -1), (1, 0), (1, 1), (2, 37)]


@pytest.mark.parametrize("k,d", KERNEL_CASES,
                         ids=[f"{k}S64{d:+d}" if k else str(d) for k, d in KERNEL_CASES])
def test_kernel_matches_plain(model, k, d):
    """Kernel 1 against its plain version per output slice, and bitwise
    equal across launches; each launch adds its tiles and the tiles whose
    PE ran ahead (``fwd_schedule``) to the counters, which read >= 99%
    ahead at a view's coarse chunk."""
    cfg, m = model
    n = k * _sms() * 64 + d
    in8, _ = _in8(n, n)
    ops = m.fused_operands(cfg)
    before = fm.fused_mlp_forward.launches
    tiles0, ahead0 = _tile_counters()
    got = fm.fused_mlp_forward(ops, in8)
    again = fm.fused_mlp_forward(ops, in8)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == before + 2
    _, tiles, ahead = fm.fwd_schedule(n, _sms())
    tiles1, ahead1 = _tile_counters()
    assert (tiles1 - tiles0, ahead1 - ahead0) == (2 * tiles, 2 * ahead)
    if n == 2_097_152:
        assert ahead / tiles >= 0.99
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    ref = fm.fused_mlp_forward_plain(ops.packed, ops.pe, in8)
    assert got.shape == (n, fm.OUT_W) and got.dtype == torch.bfloat16
    for a, b in SLICES:
        x, y = got[:, a:b].float(), ref[:, a:b].float()
        assert (x - y).abs().max().item() / max(y.abs().max().item(), 1.0) < 2e-2, (a, b)


@pytest.mark.parametrize("k,d", [(0, 1), (0, 4_097), (0, 196_608), (1, 1), (2, 37)],
                         ids=["1", "4097", "196608", "1S64+1", "2S64+37"])
def test_saving_instance_gives_the_serving_output(model, k, d):
    """Kernel 1's training (saving) instance gives bitwise the serving
    instance's output, writes a saved forward of ``backward_scratch``'s
    size, and counts its tiles in ``fwd.saved_tiles`` beside ``fwd.tiles``;
    the serving launch moves ``fwd.saved_tiles`` not at all."""
    cfg, m = model
    n = k * _sms() * 64 + d
    in8, _ = _in8(n, n + 5)
    ops = m.fused_operands(cfg)
    before = fm.fused_mlp_forward.launches
    saved0 = trace.snapshot()["counters"].get("fwd.saved_tiles", 0)
    serve = fm.fused_mlp_forward(ops, in8)
    saved1 = trace.snapshot()["counters"].get("fwd.saved_tiles", 0)
    out, saved = fm.fused_mlp_forward_saving(ops, in8)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == before + 2
    _, tiles, _ = fm.fwd_schedule(n, _sms())
    assert (saved1 - saved0, trace.snapshot()["counters"]["fwd.saved_tiles"] - saved1) == (
        0, tiles)
    assert torch.equal(out.view(torch.int16), serve.view(torch.int16))
    acts, masks, *_ = fm.backward_scratch(n, 1)
    assert saved.buf.dtype == torch.bfloat16 and saved.buf.numel() == acts + 2 * masks
    assert saved.in8 is in8


def test_kernel_rows_do_not_depend_on_the_launch(model):
    """A launch over a 64-aligned slice of the points gives bitwise the
    rows of the full launch, though its tiles land on other blocks, other
    feature buffers and other turns of the weight ring: a feature buffer
    read stale or released early would show here."""
    cfg, m = model
    s = _sms()
    n = 2 * s * 64 + 37
    in8, _ = _in8(n, 7)
    ops = m.fused_operands(cfg)
    full = fm.fused_mlp_forward(ops, in8).view(torch.int16)
    for a, b in [(0, 1), (1, s + 3), (s - 1, 2 * s + 1), (3, 4), (2 * s, 2 * s + 1)]:
        lo, hi = 64 * a, min(64 * b, n)
        part = fm.fused_mlp_forward(ops, in8[lo:hi]).view(torch.int16)
        torch.cuda.synchronize()
        assert torch.equal(part, full[lo:hi]), (a, b)


def test_kernel_in_a_cuda_graph_equals_eager(model):
    """Kernel 1 captured in a CUDA graph (the SM count is read on the
    host, once) and replayed twice gives bitwise the eager output."""
    cfg, m = model
    in8, _ = _in8(196_608 + 11, 3)
    ops = m.fused_operands(cfg)
    eager = fm.fused_mlp_forward(ops, in8)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fm.fused_mlp_forward(ops, in8)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


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
        host = PackedMLP(cfg, device="cpu")
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


@pytest.mark.parametrize("n", [1, 64, 4_097, 65_536, 196_608, 100_003, 8_448, 8_512, 131_072,
                               262_144])
def test_backward_kernel_matches_plain_and_is_deterministic(model, n):
    """Kernel 2 below one 64-point tile, at exactly one, at a ragged count
    that leaves a part-filled chunk of the weight products, at the Replica
    step's coarse and fine sizes, at a ragged step size, at one tile a
    block and at a block's second tile on 132 SMs (8,448 and 8,512), and
    at fern's coarse and fine sizes, against its plain version; bitwise
    equal across launches; each launch adds its tiles and those staged
    ahead (``bwd_schedule``) to the counters."""
    cfg, m = model
    ops = m.fused_operands(cfg)
    in8, gen = _in8(n, n)
    out, saved = fm.fused_mlp_forward_saving(ops, in8)
    target = torch.rand(out.shape, device="cuda", generator=gen)
    g = (out.float() - target) / n
    g[:, 8 + C:] = 0.0
    g = g.to(torch.bfloat16)
    before = fm.fused_mlp_backward.launches
    tiles0, ahead0 = _tile_counters("bwd")
    got = fm.fused_mlp_backward(ops, saved, g)
    again = fm.fused_mlp_backward(ops, saved, g)
    torch.cuda.synchronize()
    assert fm.fused_mlp_backward.launches == before + 2
    _, tiles, ahead = fm.bwd_schedule(n, _sms())
    tiles1, ahead1 = _tile_counters("bwd")
    assert (tiles1 - tiles0, ahead1 - ahead0) == (2 * tiles, 2 * ahead)
    assert all(torch.equal(got[k], again[k]) for k in got)
    ref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
    masks = fm.packed_grad_masks(m.state_dict(), cfg)
    keys = [k for k in ref if float((ref[k] * masks[k]).abs().max()) > 0]
    cos, rel = _cos_rel(torch.cat([(got[k] * masks[k]).flatten() for k in keys]),
                        torch.cat([(ref[k] * masks[k]).flatten() for k in keys]))
    assert cos > 0.999 and rel <= 1e-2, (cos, rel)
    for k in keys:
        cos, rel = _cos_rel(got[k] * masks[k], ref[k] * masks[k])
        assert cos > 0.999 and rel <= 1e-2, (k, cos, rel)


def test_saving_forward_and_backward_in_a_cuda_graph_equal_eager(model):
    """Kernel 1's saving instance and kernel 2 captured in one CUDA graph
    and replayed twice give bitwise the eager output and gradients."""
    cfg, m = model
    n = 196_608 + 11
    in8, gen = _in8(n, 13)
    ops = m.fused_operands(cfg)
    target = torch.rand((n, fm.OUT_W), device="cuda", generator=gen)

    def fwd_bwd():
        out, saved = fm.fused_mlp_forward_saving(ops, in8)
        return (out, *fm.fused_mlp_backward_flat(ops, saved, ((out.float() - target) / n).to(
            torch.bfloat16)))

    eager = [t.clone() for t in fwd_bwd()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fwd_bwd()
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(got, eager):
            assert torch.equal(_bits(x), _bits(y))


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


def test_captured_step_counts_backward_tiles(graph_setup, monkeypatch):
    """A replay of a captured block adds, for each kernel-2 call the
    capture recorded, its tiles and those staged ahead (``bwd_schedule``)
    to the counters: the wrapper runs only while the block is captured."""
    step, state, pools, table, w_c, gen, snap = graph_setup
    seen = []
    inner = fm.fused_mlp_backward_flat

    def spy(ops, saved, g):
        seen.append(saved.in8.shape[0])
        return inner(ops, saved, g)

    monkeypatch.setattr(fm, "fused_mlp_backward_flat", spy)
    multi = make_multi_step(step, GRAPH_K)
    restore_state(state, snap, gen)
    multi(state, pools, table, w_c, gen)  # the warm-up step, the capture, a replay
    torch.cuda.synchronize()
    captured = seen[-2 * GRAPH_K:]
    tiles0, ahead0 = _tile_counters("bwd")
    multi(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    tiles1, ahead1 = _tile_counters("bwd")
    assert multi.replayed["fused_mlp_bwd"] == multi.replays * len(captured) == 4 * GRAPH_K
    want = [fm.bwd_schedule(n, _sms()) for n in captured]
    assert (tiles1 - tiles0, ahead1 - ahead0) == (sum(w[1] for w in want), sum(w[2] for w in want))
    assert sum(w[2] for w in want) > 0


def test_saved_tiles_count_the_backward_tiles(graph_setup, model):
    """A replay of a captured training block moves ``fwd.saved_tiles`` by
    as much as ``bwd.tiles``: each backward call reads one saving forward's
    tiles; a render (the serving instance) moves it not at all."""
    step, state, pools, table, w_c, gen, snap = graph_setup
    multi = make_multi_step(step, GRAPH_K)
    restore_state(state, snap, gen)
    multi(state, pools, table, w_c, gen)  # the warm-up step, the capture, a replay
    torch.cuda.synchronize()

    def counts():
        c = trace.snapshot()["counters"]
        return c.get("fwd.saved_tiles", 0), c.get("bwd.tiles", 0)

    saved0, bwd0 = counts()
    multi(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    saved1, bwd1 = counts()
    assert saved1 - saved0 == bwd1 - bwd0 > 0
    cfg, m = model
    c2w = torch.eye(4, device="cuda")
    c2w[2, 3] = -1.0
    rays = create_rays(c2w, 12, 16, 8.0, 8.0, 7.5, 5.5, 0.1, 10.0)[0]
    tiles0 = _tile_counters()[0]
    with torch.no_grad():
        render_rays_chunked(m, m, cfg, rays, RenderConfig(), chunk=64)
    torch.cuda.synchronize()
    assert counts()[0] == saved1 and _tile_counters()[0] > tiles0


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


# ---- the heads' kernels (csrc/packed_heads.cu) ---------------------------

HEADS = ("sigma", "albedo", "shading", "residual", "rgb", "sem")


def _heads_inputs(p, c, seed, absent=()):
    """A packed bf16 output of ``p`` points (zero past the ``c`` classes,
    as kernel 1 writes it) as ``(rays, samples)``, and seeded gradients of
    the six heads, ``None`` where ``absent`` (and the semantic one at c = 0)."""
    n, s = (p // 64, 64) if p % 64 == 0 else (p, 1)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.randn(p, fm.OUT_W, device="cuda", generator=g) * 3
    out[:, 8 + c:] = 0.0
    shapes = ((n, s), (n, s, 3), (n, s), (n, s, 3), (n, s, 3), (n, s, c))
    grads = [None if h in absent or (h == "sem" and c == 0)
             else torch.randn(shape, device="cuda", generator=g)
             for h, shape in zip(HEADS, shapes)]
    return out.to(torch.bfloat16), n, s, grads


def _eager_heads(out, n, s, c, grads):
    """The heads and the bf16 cotangent of the eager expressions on the
    card: autograd through ``packed_heads_forward_plain``, the fp32 copy of
    the output cut into slices, whose zero-filled gradients autograd sums
    and casts back to bf16."""
    x = out.clone().requires_grad_(True)
    heads = fm.packed_heads_forward_plain(x, n, s, c)
    used = [i for i, g in enumerate(grads) if g is not None]
    torch.autograd.backward([heads[i] for i in used], [grads[i] for i in used])
    return [h.detach() for h in heads], x.grad


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


HEADS_CASES = [(p, c, ()) for p in (1, 4_097, 196_608) for c in (0, C, 40)] + [
    (4_097, C, ("rgb", "sem")), (65_536, 0, ("albedo", "shading")), (100_003, C, ("sigma",))]


@pytest.mark.parametrize("p,c,absent", HEADS_CASES,
                         ids=[f"{p}-C{c}" + "".join(f"-no_{h}" for h in a)
                              for p, c, a in HEADS_CASES])
def test_heads_kernels_match_the_eager_expressions(card, p, c, absent):
    """The heads' forward kernel bitwise the eager expressions' values, and
    bitwise across launches; the backward kernel's cotangent bitwise the
    eager one in every column but the shading logit's, which may differ by
    one bf16 ulp where ATen sums its three products in another order; both
    at one point, at counts that are not a multiple of a block, at C = 0,
    27 and 40, and with heads' gradients absent.  Each launch is counted."""
    out, n, s, grads = _heads_inputs(p, c, p + c, absent)
    before = (fm.packed_heads_forward.launches, fm.packed_heads_backward.launches)
    counted = trace.snapshot()["counters"]
    got = fm.packed_heads_forward(out, n, s, c)
    again = fm.packed_heads_forward(out, n, s, c)
    cot = fm.packed_heads_backward(grads, got[1], got[2], got[3], c)
    torch.cuda.synchronize()
    now = trace.snapshot()["counters"]
    assert (fm.packed_heads_forward.launches, fm.packed_heads_backward.launches) == (
        before[0] + 2, before[1] + 1)
    assert now["heads.fwd_points"] - counted.get("heads.fwd_points", 0) == 2 * p
    assert now["heads.bwd_points"] - counted.get("heads.bwd_points", 0) == p
    ref, ref_cot = _eager_heads(out, n, s, c, grads)
    for h, x, y, z in zip(HEADS, got, again, ref):
        assert x.shape == z.shape and x.is_contiguous(), h
        assert torch.equal(_bits(x), _bits(y)) and torch.equal(_bits(x), _bits(z)), h
    assert cot.dtype == torch.bfloat16 and cot.shape == (p, fm.OUT_W)
    a, b = _bits(cot).int(), _bits(ref_cot).int()
    others = torch.ones(fm.OUT_W, dtype=torch.bool, device="cuda")
    others[4] = False
    assert torch.equal(a[:, others], b[:, others])
    ulps = (a[:, 4] - b[:, 4]).abs()
    assert int(ulps.max()) <= 1, (int((ulps > 0).sum()), int(ulps.max()))
    assert not cot[:, 8 + c:].any()


def test_heads_kernels_in_a_cuda_graph_equal_eager(card):
    """Both heads' kernels captured in one CUDA graph and replayed twice give
    bitwise the eager heads and cotangent; the capture counts each once in
    ``.captured``."""
    out, n, s, grads = _heads_inputs(196_608 + 11, C, 9)
    eager = fm.packed_heads_forward(out, n, s, C)
    eager_cot = fm.packed_heads_backward(grads, *eager[1:4], C)
    torch.cuda.synchronize()
    before = (fm.packed_heads_forward.captured, fm.packed_heads_backward.captured)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        heads = fm.packed_heads_forward(out, n, s, C)
        cot = fm.packed_heads_backward(grads, *heads[1:4], C)
    assert (fm.packed_heads_forward.captured, fm.packed_heads_backward.captured) == (
        before[0] + 1, before[1] + 1)
    for _ in range(2):
        for t in (*heads, cot):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip((*heads, cot), (*eager, eager_cot)):
            assert torch.equal(_bits(x), _bits(y))


def test_graphed_step_makes_no_fp32_copy_of_the_packed_output(graph_setup):
    """A graphed Replica-width block traced with shapes: its warm-up step
    and its capture fill, add, copy or cast no tensor of the packed
    output's [P, 128] (the eager heads' fp32 copy, zero-filled slice
    gradients and their sums); a traced replay runs each heads' kernel
    twice a step."""
    from torch.profiler import ProfilerActivity, profile

    step, state, pools, table, w_c, gen, snap = graph_setup
    multi = make_multi_step(step, GRAPH_K)
    restore_state(state, snap, gen)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        multi(state, pools, table, w_c, gen)  # the warm-up step, the capture, a replay
        torch.cuda.synchronize()
    events = prof.events()
    points = {e.input_shapes[0][0] for e in events if e.name == "FusedMLP" and e.input_shapes}
    assert len(points) == 2, points  # the coarse and the fine call

    def packed(shape):
        return (isinstance(shape, list) and len(shape) >= 2 and shape[-1] == fm.OUT_W
                and math.prod(shape[:-1]) in points)

    touched = sorted({e.name for e in events if any(packed(x) for x in e.input_shapes or [])})
    banned = [name for name in touched
              if any(w in name for w in ("fill", "zero", "add", "copy", "to_copy"))]
    assert not banned, touched
    assert "PackedHeads" in {e.name for e in events}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        multi(state, pools, table, w_c, gen)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel in ("packed_heads_fwd_kernel", "packed_heads_bwd_kernel"):
        assert sum(kernel in x for x in names) == 2 * GRAPH_K, kernel


# ---- the object configuration (semantic head off) ----------------------


@pytest.fixture(scope="module")
def object_model(card):
    cfg = MLPConfig(pos_scalar_factor=1.0, enable_semantic=False, compute_dtype=torch.bfloat16,
                    use_fused_kernel=True)
    return cfg, PackedMLP(cfg, device=card, generator=torch.Generator().manual_seed(1))


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
    out, saved = fm.fused_mlp_forward_saving(ops, in8)
    g = (out.float() - torch.rand(out.shape, device="cuda", generator=gen)) / n
    g[:, 8:] = 0.0  # the object model reads sigma, albedo, shading and residual
    g = g.to(torch.bfloat16)
    got = fm.fused_mlp_backward(ops, saved, g)
    again = fm.fused_mlp_backward(ops, saved, g)
    torch.cuda.synchronize()
    assert all(torch.equal(got[k], again[k]) for k in got)
    masks = fm.packed_grad_masks(m.state_dict(), cfg)
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


@pytest.mark.parametrize("n", [1, 4_097, 8_448, 262_144])
def test_object_backward_kernel_matches_plain(object_model, n):
    """Kernel 2 with the semantic head off (C = 0, as fern trains) on a
    saving forward, at one point, a ragged count, one tile a block on 132
    SMs and fern's fine call, against its plain version at kernel 2's
    bounds, bitwise across launches."""
    cfg, m = object_model
    ops = m.fused_operands(cfg)
    in8, gen = _in8(n, n + 1)
    out, saved = fm.fused_mlp_forward_saving(ops, in8)
    g = (out.float() - torch.rand(out.shape, device="cuda", generator=gen)) / n
    g[:, 8:] = 0.0
    g = g.to(torch.bfloat16)
    got = fm.fused_mlp_backward(ops, saved, g)
    again = fm.fused_mlp_backward(ops, saved, g)
    torch.cuda.synchronize()
    assert all(torch.equal(got[k], again[k]) for k in got)
    ref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
    masks = fm.packed_grad_masks(m.state_dict(), cfg)
    keys = [k for k in ref if float((ref[k] * masks[k]).abs().max()) > 0]
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


NDC_K = 8


def test_graphed_ndc_object_steps_equal_eager_steps(object_model, graph_setup):
    """8 forward-facing object steps in NDC (fern's field of view, the pose
    sampler given the NDC focal, no precrop, 64 + 64 samples, sigma noise
    1, 1,024 pairs) as one replay equal the same 8 eager steps bitwise.
    The capture holds 14 clock stamps a step (the five phases' and the
    sampler's ``sample.rays`` and ``sample.ndc``), Replica's 10; a
    replay made with spans on gives the sampler's spans the steps' ids."""
    import types

    from intrinsicnerf_tpu_torch.core.rays import camera_ray_dirs
    from intrinsicnerf_tpu_torch.train.step import PosePools
    from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, make_object_sample_fn
    from intrinsicnerf_tpu_torch.utils import trace

    def stamp_nodes():
        return trace.snapshot()["counters"].get("graph.stamp_nodes", 0)

    cfg, _ = object_model
    h, w = 48, 64
    focal = 0.5 * w / 0.6183  # fern's: 407.5658 px at 504
    gen = torch.Generator(device="cuda").manual_seed(6)
    poses = torch.eye(4, device="cuda").repeat(3, 1, 1)
    poses[:, :3, 3] = torch.tensor([[0.1, 0.0, 0.02], [-0.2, 0.1, 0.0], [0.0, -0.1, -0.03]],
                                   device="cuda")
    pools = PosePools(dirs_cam=camera_ray_dirs(h, w, focal, focal, w * 0.5, h * 0.5, "opengl",
                                               device="cuda").reshape(-1, 3),
                      poses=poses, rgb=torch.rand(3, h * w, 3, device="cuda", generator=gen),
                      mask=torch.ones(3, h * w, device="cuda"))
    bundle = SceneBundle(pools=pools, rays_vis=None, rays_test=None, h=h, w=w, h_scaled=h,
                         w_scaled=w, num_valid_classes=0)
    tcfg = TrainConfig(n_rays=1024, mask_mode="mask", no_semantic_tree=True)
    ocfg = types.SimpleNamespace(depth_range=(0.0, 1.0), train=tcfg, precrop_iters=0,
                                 precrop_frac=0.5)
    rcfg = RenderConfig(n_coarse=64, n_importance=64, perturb=1.0, raw_noise_std=1.0)
    step = make_train_step(cfg, rcfg, tcfg, h, w,
                           sample_fn=make_object_sample_fn(ocfg, bundle, ndc_focal=focal))
    state = create_train_state(cfg, tcfg, device="cuda")
    table = empty_cluster_table(1, 64, device="cuda")
    w_c = torch.tensor(0.1, device="cuda")
    step(state, pools, table, w_c, gen)  # Adam's state made
    snap = snapshot_state(state, gen)

    def eager():
        for _ in range(NDC_K):
            rep = step(state, pools, table, w_c, gen)
        return rep

    first, second = _run(state, snap, gen, eager), _run(state, snap, gen, eager)
    assert _agree(first, second, True)
    multi = make_multi_step(step, NDC_K)
    before = stamp_nodes()
    graphed = _run(state, snap, gen, lambda: multi(state, pools, table, w_c, gen))
    assert stamp_nodes() - before == 14 * NDC_K
    assert _agree(graphed, first, True) and all(torch.isfinite(v) for v in graphed[0])
    restore_state(state, snap, gen)
    with trace.recording():
        multi(state, pools, table, w_c, gen)
    spans = trace.snapshot()["spans"]
    steps = list(range(snap["step"], snap["step"] + NDC_K))
    for name in ("sample.rays", "sample.ndc"):
        assert [i for i, _, _ in spans[name]["intervals_s"][-NDC_K:]] == steps, name
    r_step, r_state, r_pools, r_table, r_w_c, r_gen, _ = graph_setup
    before = stamp_nodes()
    make_multi_step(r_step, NDC_K)(r_state, r_pools, r_table, r_w_c, r_gen)
    assert stamp_nodes() - before == 10 * NDC_K



@pytest.mark.parametrize("classes", [C, 0], ids=["scene", "object"])
def test_graphed_packed_steps_keep_padded_slots(card, classes):
    """The packed training state taking GRAPH_K graphed steps (one replay
    each): finite losses after every step, the padded slots of both
    levels exactly zero in the buffers and in Adam's moments, and the
    real slots moved."""
    cfg = MLPConfig(pos_scalar_factor=10.0, enable_semantic=classes > 0,
                    num_semantic_classes=classes, compute_dtype=torch.bfloat16,
                    use_fused_kernel=True)
    h, w = 24, 32
    c2w = torch.eye(4, device="cuda").repeat(2, 1, 1)
    c2w[:, 2, 3] = torch.tensor([-1.0, -1.3])
    rays = create_rays(c2w, h, w, 16.0, 16.0, 15.5, 11.5, 0.1, 10.0)
    g0 = torch.Generator(device="cuda").manual_seed(3)
    sem = (torch.randint(0, classes + 1, (2, h * w), device="cuda", generator=g0) if classes
           else (torch.rand(2, h * w, device="cuda", generator=g0) > 0.3).float())
    pools = DataPools(rays=rays, rgb=torch.rand(2, h * w, 3, device="cuda", generator=g0),
                      semantic=sem, mask_ids=torch.ones(2, dtype=torch.int32, device="cuda"))
    tcfg = TrainConfig(n_rays=128, mask_mode="label" if classes else "mask")
    step = make_train_step(cfg, RenderConfig(perturb=1.0, raw_noise_std=1.0), tcfg, h, w)
    table = empty_cluster_table(max(classes, 1), 64, device="cuda")
    w_c = torch.tensor(0.1, device="cuda")
    state = create_train_state(cfg, tcfg, device="cuda", generator=torch.Generator().manual_seed(4))
    assert isinstance(state.model_fine, PackedMLP)
    first = [p.detach().clone() for p in state.optimizer.param_groups[0]["params"]]
    gen = torch.Generator(device="cuda").manual_seed(5)
    multi = make_multi_step(step, 1)
    for i in range(GRAPH_K):
        rep = torch.stack(list(multi(state, pools, table, w_c, gen)))
        assert torch.isfinite(rep).all(), (i, rep)
        for m in (state.model_coarse, state.model_fine):
            for p, mask in ((m.weight, m.weight_mask), (m.bias, m.bias_mask)):
                assert not p.detach()[mask == 0].any(), i
                assert all(not v[mask == 0].any() for k, v in state.optimizer.state[p].items()
                           if k != "step"), i
    for p, p0 in zip(state.optimizer.param_groups[0]["params"], first):
        assert not torch.equal(p.detach(), p0)


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
    m = PackedMLP(cfg, device=card, generator=torch.Generator().manual_seed(c))
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
    saving, saved = fm.fused_mlp_forward_saving(ops, in8)
    assert torch.equal(saving.view(torch.int16), got.view(torch.int16))
    bwd = fm.fused_mlp_backward(ops, saved, g)
    bwd2 = fm.fused_mlp_backward(ops, saved, g)
    torch.cuda.synchronize()
    assert all(torch.equal(bwd[k], bwd2[k]) for k in bwd)
    bref = fm.fused_mlp_backward_plain(ops.packed, ops.pe, in8, g)
    masks = fm.packed_grad_masks(m.state_dict(), cfg)
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
    host = PackedMLP(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    occ_p, _ = query_density_grid(host, cfg, pts[:20_000], 0.05, chunk=131_072)
    assert occ.shape == (300_000,) and sem.shape == (300_000,)
    assert np.abs(occ[:20_000] - occ_p).max() < 2e-2 and np.isfinite(occ).all()
