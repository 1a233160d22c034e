"""The port's forward-facing (LLFF) training path in NDC against the
benchmark's plain reference of it (``perfbench/reference/ndc.py``), on
the CPU.

At a tiny size of the ``fern`` configuration (width 32, 8 + 8 samples,
8 pairs, 6 views of 12 x 16 at fern's field of view and camera spread),
from the benchmark's seeded weights (the published initialisation,
density bias 1), on the port's plain layers at float32: the pose
sampler given the NDC focal (``make_object_sample_fn``) and the training
step (``make_train_step``), against the reference's draws, projection,
render, losses and Adam from the same generator seed.  With spans on,
the sampler's two spans (``sample.rays``, ``sample.ndc``) nest in the
step's ``step.sample`` and take its id, the step.

Tolerances:

- the rays of one draw: both sides gather the same pixel directions,
  take the same 3x3 product and evaluate nerf-pytorch's projection term
  for term in float32, so they agree to a few float32 ulps: the worst gap
  of the origins, the directions and the view directions over the
  block's RMS below 1e-6 (a wrong focal or a missing projection moves
  them by their own size), colours and masks exactly;
- the view directions: the unit world directions (1e-6 as above), and
  at least 1e-2 off the unit NDC directions (they differ by O(1) at
  this field of view);
- three steps: each step's total loss within 1e-5 relative (the port
  and the reference sum the same float32 terms in other orders; the
  gaps seen are ~1e-7); the first gradient, by the worst leaf's gap of
  norms against max(its norm, the median leaf's), within 1e-5 (seen:
  ~1e-6), and elementwise within 1e-3 of the leaf's largest entry (sums
  over 16 rays x 16 samples that cancel leave ~4e-5 on some entries; a
  wrong batch moves them by O(1)); the parameters' change over the three
  steps within 1e-3 by the same norm rule (Adam divides by the root of
  its second moment, which lifts the gradients' round-off of small
  leaves to ~1e-5, and the check on the card allows 0.1).
"""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import forward_facing, scenes, system  # noqa: E402
from perfbench import run as harness  # noqa: E402
from perfbench.reference import compare, ndc  # noqa: E402
from perfbench.reference import config as rconf  # noqa: E402

from intrinsicnerf_tpu_torch.train import step as tstep  # noqa: E402
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, make_object_sample_fn  # noqa: E402
from intrinsicnerf_tpu_torch.utils import trace  # noqa: E402

SEED = 2147483647 + 12


def _tiny_fern():
    c = copy.deepcopy(harness.data_file("configs", "fern"))
    c["dataset"].update(height=12, width=16, train_views=6, test_views=5)
    c["added"].update(netwidth=32, N_samples=8, N_importance=8, chunk=64,
                      compute_dtype="float32")
    c["published"].update(N_rand=8, use_fused_kernel=False)
    return c


@pytest.fixture(scope="module")
def fern(tmp_path_factory):
    config = _tiny_fern()
    arch, hp, ds = rconf.arch(config), rconf.hyper(config), config["dataset"]
    cfg = system.framework_config(config, str(tmp_path_factory.mktemp("fern")))
    cfg.depth_range = (ds["near"], ds["far"])
    data = forward_facing.train_data(ds, scenes.generator(SEED, 1, "cpu"), "cpu")
    weights = scenes.make_weights(arch, scenes.generator(SEED, 2, "cpu"), "cpu")
    focal = forward_facing.focal(ds)
    pools = tstep.PosePools(dirs_cam=data["dirs_cam"], poses=data["poses"], rgb=data["rgb"],
                            mask=data["mask"])
    bundle = SceneBundle(pools=pools, rays_vis=None, rays_test=None, h=ds["height"],
                         w=ds["width"], h_scaled=ds["height"], w_scaled=ds["width"],
                         num_valid_classes=0)
    sample_fn = make_object_sample_fn(cfg, bundle, ndc_focal=focal)
    return dict(config=config, arch=arch, hp=hp, cfg=cfg, data=data, weights=weights,
                focal=focal, pools=pools, sample_fn=sample_fn)


def _draws(f, seed):
    prog = f["sample_fn"](torch.Generator().manual_seed(seed), f["pools"], 0)
    ref = ndc.draw_batch(torch.Generator().manual_seed(seed), f["data"], f["hp"], f["focal"], 0)
    return prog, ref


def _rel(a, b):
    return float((a - b).abs().max() / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_ndc_rays_of_one_draw(fern, seed):
    prog, ref = _draws(fern, seed)
    assert prog.rays.shape == ref["rays"].shape == (16, 11)
    for lo, hi in ((0, 3), (3, 6), (8, 11)):
        assert _rel(prog.rays[:, lo:hi], ref["rays"][:, lo:hi]) < 1e-6, (lo, hi)
    assert torch.equal(prog.rays[:, 6:8], torch.tensor([0.0, 1.0]).expand(16, 2))
    assert torch.equal(prog.rgb, ref["rgb"]) and torch.equal(prog.semantic, ref["label"])
    # a focal of the full-size images (8x) lands far off the reference
    wrong = ndc.draw_batch(torch.Generator().manual_seed(seed), fern["data"], fern["hp"],
                           8.0 * fern["focal"], 0)
    assert ndc.ray_gap((prog.rays, prog.rgb, prog.semantic),
                       (wrong["rays"], wrong["rgb"], wrong["label"])) > 1.0
    assert ndc.ray_gap((prog.rays, prog.rgb, prog.semantic),
                       (ref["rays"], ref["rgb"], ref["label"])) < 1e-6


def test_view_directions_are_taken_before_the_projection(fern):
    prog, _ = _draws(fern, 3)
    world = ndc.draw_batch(torch.Generator().manual_seed(3), fern["data"], fern["hp"], None, 0)
    assert _rel(prog.rays[:, 8:11], world["rays"][:, 3:6] / world["rays"][:, 3:6].norm(
        dim=-1, keepdim=True)) < 1e-6
    unit_ndc = prog.rays[:, 3:6] / prog.rays[:, 3:6].norm(dim=-1, keepdim=True)
    assert float((prog.rays[:, 8:11] - unit_ndc).abs().max()) > 1e-2


def test_three_steps_against_the_reference(fern):
    f = fern
    mcfg = system.mlp_config(f["cfg"], 0)
    state = tstep.create_train_state(mcfg, f["cfg"].train, device="cpu", with_fine=True)
    system.load_weights(state, f["weights"])
    step = tstep.make_train_step(mcfg, f["cfg"].render, f["cfg"].train, 12, 16,
                                 sample_fn=f["sample_fn"])
    gen = torch.Generator().manual_seed(SEED)
    losses, grads = {}, None
    for s in range(1, 4):
        losses[s] = float(step(state, f["pools"], None, 0.0, gen).total)
        if grads is None:
            grads = system.grad_leaves(state)
    ref_losses, ref_grads, ref_params = ndc.follow(
        f["weights"], f["data"], SEED, 3, f["arch"], f["hp"], f["focal"], None, 0.0,
        observe=(1, 2, 3))
    for s in (1, 2, 3):
        assert abs(losses[s] - ref_losses[s]) <= 1e-5 * abs(ref_losses[s]), s
    assert compare.worst_leaf_gap(grads, ref_grads) < 1e-5
    for lvl in ref_grads:
        for k, r in ref_grads[lvl].items():
            assert float((grads[lvl][k] - r).abs().max()) <= 1e-3 * max(
                float(r.abs().max()), 1e-12), (lvl, k)
    after = system.state_leaves(state)
    assert compare.worst_leaf_gap(compare.delta(after, f["weights"]),
                                  compare.delta(ref_params, f["weights"]),
                                  compare.moving_leaves(ref_grads)) < 1e-3
    # the projection left out: another trajectory, far outside these bounds
    off, _, _ = ndc.follow(f["weights"], f["data"], SEED, 1, f["arch"], f["hp"], None, None,
                           0.0, observe=(1,))
    assert abs(off[1] - ref_losses[1]) > 1e-3 * abs(ref_losses[1])


def test_sampler_spans_nest_in_the_step_and_take_its_id(fern, monkeypatch):
    f = fern
    mcfg = system.mlp_config(f["cfg"], 0)
    state = tstep.create_train_state(mcfg, f["cfg"].train, device="cpu", with_fine=True)
    step = tstep.make_train_step(mcfg, f["cfg"].render, f["cfg"].train, 12, 16,
                                 sample_fn=f["sample_fn"])
    closed, exit_ = [], trace.RECORDER.exit
    monkeypatch.setattr(trace.RECORDER, "exit", lambda s: (closed.append(s), exit_(s)))
    state.step = 5
    with trace.recording():
        step(state, f["pools"], None, 0.0, torch.Generator().manual_seed(1))
    got = [(s.name, s.id, s.parent.name) for s in closed if s.name.startswith("sample.")]
    assert got == [("sample.rays", 5, "step.sample"), ("sample.ndc", 5, "step.sample")]
    closed.clear()
    with trace.recording():  # outside any span: no id to take
        f["sample_fn"](torch.Generator().manual_seed(1), f["pools"], 0)
    assert [(s.name, s.id, s.parent) for s in closed] == [("sample.rays", None, None),
                                                          ("sample.ndc", None, None)]
