"""The plain reference against hand-built tiny cases."""

import math

import pytest
import torch

from perfbench.reference import cluster, compare, nerf
from perfbench.reference import train as rtrain

ARCH = {"depth": 3, "width": 8, "skips": (1,), "n_freqs_pos": 1, "n_freqs_dir": 1,
        "pos_scale": 1.0, "classes": 2, "n_coarse": 4, "n_importance": 4, "perturb": 0.0,
        "raw_noise_std": 0.0, "white_bkgd": False}


def test_encoding_order():
    x = torch.tensor([[0.5, -1.0, 2.0]])
    e = nerf.encode(x, 2, scale=2.0)
    y = x / 2.0
    want = torch.cat([y, torch.sin(y), torch.cos(y), torch.sin(2 * y), torch.cos(2 * y)], -1)
    assert torch.equal(e, want)


def test_layer_shapes_follow_the_published_names():
    shapes = nerf.layer_shapes(ARCH)
    assert shapes["pts_linears.0.weight"] == (8, 9)
    assert shapes["pts_linears.2.weight"] == (8, 8 + 9)  # after the skip at 1
    assert shapes["views_linears.0.weight"] == (4, 8 + 9)
    assert shapes["semantic_linear.1.weight"] == (2, 4)


def test_zero_network_gives_the_heads_biases():
    params = {k: torch.zeros(s) for k, s in nerf.layer_shapes(ARCH).items()}
    out = nerf.network(params, ARCH, torch.rand(5, 4, 3), torch.rand(5, 3))
    assert torch.equal(out["sigma"], torch.zeros(5, 4))
    assert torch.allclose(out["rgb"], torch.full((5, 4, 3), 0.5 * 0.5 + 0.5))


def test_composite_two_samples():
    raw = {"sigma": torch.tensor([[math.log(2.0), 1.0]]), "shading": torch.tensor([[1.0, 0.0]]),
           "rgb": torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])}
    z = torch.tensor([[1.0, 2.0]])
    maps = nerf.composite(raw, z, torch.tensor([[0.0, 0.0, 1.0]]), None, white_bkgd=False)
    # first: alpha 1/2; second: an infinite interval, alpha 1, weight (1/2)(1 + 1e-10)
    assert torch.allclose(maps["weights"], torch.tensor([[0.5, 0.5]]))
    assert torch.allclose(maps["rgb"], torch.tensor([[0.5, 0.5, 0.0]]))
    assert torch.allclose(maps["depth"], torch.tensor([1.5]))
    assert torch.allclose(maps["disp"], torch.tensor([1 / 1.5]))


def test_inverse_cdf_of_even_weights_is_linear():
    bins = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    u = torch.tensor([[0.0, 0.5, 1.0]])
    z = nerf.inverse_cdf(bins, torch.ones(1, 3), u)
    assert torch.allclose(z, torch.tensor([[0.0, 1.5, 3.0]]))


def test_quantize_rounds_down_in_precision():
    x = torch.randn(1000)
    e16 = (nerf.quantize(x, "bfloat16") - x).abs().max()
    e8 = (nerf.quantize(x, "float8") - x).abs().max()
    assert 0 < e16 < e8
    assert torch.equal(nerf.quantize(x, "float32"), x)


def test_adam_first_step_moves_by_the_rate():
    p = {"a": torch.tensor([1.0, -2.0, 3.0])}
    opt = rtrain.Adam(p, {"lrate": 0.1, "lrate_decay": 1e9})
    opt.update(p, {"a": torch.tensor([0.5, -4.0, 1e-3])}, step=0)
    assert torch.allclose(p["a"], torch.tensor([0.9, -1.9, 2.9]), atol=1e-6)


def test_nearest_colour():
    table = {"anchors": torch.tensor([[[1 / 6, 1 / 3, 1 / 3], [0.4, 0.2, 0.1]]]),
             "colors": torch.tensor([[[0.1, 0.2, 0.3], [0.7, 0.8, 0.9]]]),
             "has_cluster": torch.tensor([True]), "intensity_factor": 0.5}
    rgb = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])  # d_rgb (1/6, 1/3, 1/3): the first anchor
    out = rtrain.nearest_colour(table, rgb, torch.tensor([0]))
    assert torch.allclose(out, torch.tensor([[0.1, 0.2, 0.3]]))


def test_mean_shift_finds_separate_blobs():
    g = torch.Generator().manual_seed(0)
    means = torch.tensor([[0.2, 0.3, 0.3], [0.5, 0.1, 0.6]], dtype=torch.float64)
    x = torch.cat([m + 0.002 * torch.randn(300, 3, generator=g, dtype=torch.float64)
                   for m in means])
    centres, label = cluster.mean_shift(x, 0.05)
    assert len(centres) == 2
    assert torch.equal(label[:300], label[:1].expand(300)) and bool(label[300] != label[0])
    for c, m in zip(centres[label[[0, 300]]], means):
        assert torch.allclose(c, m, atol=1e-3)


def test_rebuilt_table_gives_each_class_its_blob_colour():
    g = torch.Generator().manual_seed(1)
    blobs = torch.tensor([[0.8, 0.2, 0.1], [0.1, 0.3, 0.7], [0.4, 0.4, 0.4]])
    rgb = torch.cat([b + 0.003 * torch.randn(200, 3, generator=g) for b in blobs])
    label = torch.tensor([0] * 400 + [2] * 200)  # class 0 holds two blobs
    table = cluster.rebuild(rgb, label, 4, band_factor=0.5)
    assert table["has_cluster"].tolist() == [True, False, True, False]
    colour, has = cluster.lookup(table, rgb, label)
    assert bool(has.all())
    for i, b in enumerate(blobs):
        assert torch.allclose(colour[200 * i:200 * (i + 1)], b.expand(200, 3), atol=2e-3)
    assert compare.table_gap(table, table, rgb, label) == 0.0
    empty = dict(table, has_cluster=torch.zeros(4, dtype=torch.bool))
    assert compare.table_gap(empty, table, rgb, label) == 1.0


def test_worst_leaf_gap_and_moving_leaves():
    ref = {"l": {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1e-9]),
                 "c": torch.tensor([1.0])}}
    prog = {"l": {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0]),
                  "c": torch.tensor([1.5])}}
    assert compare.worst_leaf_gap(prog, ref) == pytest.approx(0.5)
    assert compare.moving_leaves(ref) == ["l/a", "l/c"]


def test_render_numbers_count_pixels():
    ref = {m: torch.ones(4) for m in ("depth", "disp", "acc", "shading")}
    ref.update(rgb=torch.ones(4, 3), albedo=torch.ones(4, 3), residual=torch.ones(4, 3))
    prog = {k: v.numpy().copy() for k, v in ref.items()}
    prog["rgb"][:, 2] = 1.5  # every pixel off by half the map's RMS
    assert compare.render_numbers([(prog, ref)])["maps"] == pytest.approx(0.5)
    prog["rgb"][:, 2] = 1.0
    prog["rgb"][0, 0] = 9.0  # one pixel of four: the worst counts
    assert compare.render_numbers([(prog, ref)])["maps"] == pytest.approx(8.0)
    # the worst view counts: a sound view beside it does not dilute it
    assert compare.render_numbers([(prog, ref), (dict(ref), ref)])["maps"] == (
        compare.render_numbers([(prog, ref)])["maps"])


def test_one_reference_step_descends():
    torch.manual_seed(0)
    arch = dict(ARCH, perturb=1.0, raw_noise_std=1.0)
    hp = {"h": 4, "w": 5, "near": 0.5, "far": 3.0, "n_rays": 8, "sampler": "pool",
          "pair_mode": "label", "lrate": 1e-2, "lrate_decay": 1e9, "wgt_sem": 0.04,
          "w_chroma": 1.0, "w_n": 0.01, "w_f": 0.005, "w_s": 1.0, "w_i1": 0.1, "w_i2": 0.01,
          "w_res1": 1.0, "w_res2": 0.02, "residual_switch": 100, "intensity_switch": 50,
          "no_intrinsic_loss": False}
    n = 20
    d = torch.nn.functional.normalize(torch.randn(3, n, 3), dim=-1)
    data = {"rays": torch.cat([torch.zeros(3, n, 3), d, torch.full((3, n, 1), 0.5),
                               torch.full((3, n, 1), 3.0), d], -1),
            "rgb": torch.rand(3, n, 3), "semantic": torch.randint(0, 3, (3, n)),
            "mask_ids": torch.ones(3, dtype=torch.int64)}
    init = {"coarse": {k: torch.rand(s) * 0.2 - 0.1 for k, s in nerf.layer_shapes(arch).items()},
            "fine": {k: torch.rand(s) * 0.2 - 0.1 for k, s in nerf.layer_shapes(arch).items()}}
    losses, grads, after = rtrain.follow(init, data, 3, 2, arch, hp, None, 0.0, observe=(1, 2))
    assert set(losses) == {1, 2} and all(math.isfinite(v) for v in losses.values())
    assert any(float(g.abs().sum()) > 0 for g in grads["fine"].values())
    assert any(not torch.equal(after["coarse"][k], init["coarse"][k]) for k in init["coarse"])
    # the same seed draws the same pixels and noise: the same trajectory
    again = rtrain.follow(init, data, 3, 2, arch, hp, None, 0.0, observe=(1, 2))
    assert again[0] == losses


def test_the_port_table_matches_the_reference_on_several_clusters():
    from intrinsicnerf_tpu_torch.cluster.manager import ClusterManager
    from perfbench import system

    g = torch.Generator().manual_seed(2)
    blobs = torch.tensor([[0.8, 0.2, 0.1], [0.1, 0.3, 0.7], [0.4, 0.4, 0.4], [0.2, 0.6, 0.2]])
    rgb = torch.cat([b + 0.01 * torch.rand(500, 3, generator=g) for b in blobs])
    label = torch.tensor([0] * 1000 + [1] * 1000)
    mgr = ClusterManager(class_num=3)
    mgr.update_centers(label.numpy(), rgb.numpy(), band_factor=0.5)
    prog = system.table_copy(mgr.to_table(device="cpu"))
    ref = cluster.rebuild(rgb, label, 3, band_factor=0.5)
    assert compare.table_gap(prog, ref, rgb, label) < 1e-4
    prog["colors"] = prog["colors"][..., [1, 0, 2]]  # a table with its colours swapped
    assert compare.table_gap(prog, ref, rgb, label) > 0.1
