"""The work counts against a hand count of the published architecture."""

from perfbench import flops

SCENE = {"depth": 8, "width": 256, "skips": (4,), "n_freqs_pos": 10, "n_freqs_dir": 4,
         "classes": 27, "n_coarse": 64, "n_importance": 128}


def hand_macs(c):
    pts, dirs = 63, 27  # 3 * (1 + 2 * 10), 3 * (1 + 2 * 4)
    trunk = pts * 256 + 4 * 256 * 256 + (256 + pts) * 256 + 2 * 256 * 256
    heads = 256 * 1 + (256 * 128 + 128 * 3) + (256 * 128 + 128 * 1)
    view = 256 * 256 + (256 + dirs) * 128 + 128 * 3
    sem = 256 * 128 + 128 * c if c else 0
    return trunk + heads + view + sem


def test_macs_per_point_at_27_classes():
    assert hand_macs(27) == 695_680
    assert flops.macs_per_point(SCENE) == 695_680


def test_macs_per_point_without_semantics():
    assert flops.macs_per_point(dict(SCENE, classes=0)) == hand_macs(0) == 659_456


def test_backward_leaves_out_the_encoded_inputs():
    no_grad = 63 * 256 + 63 * 256 + 27 * 128  # layer 0, the skip's encoded half, the dirs
    assert flops.act_grad_macs_per_point(SCENE) == 695_680 - no_grad


def test_points_and_step_work():
    assert flops.points_per_ray(SCENE) == 64 + 192
    f, _ = flops.forward(SCENE, 1024)
    b, _ = flops.backward(SCENE, 1024)
    assert f == 2 * 695_680 * 262_144
    assert b == 2 * (695_680 + 695_680 - 35_712) * 262_144
    view, _ = flops.forward(SCENE, 320 * 240)
    assert abs(flops.roofline_s(*flops.forward(SCENE, 320 * 240)) - view / 989e12) < 1e-15


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_s(989e12, 1.0) == 1.0
    assert flops.roofline_s(1.0, 3.35e12) == 1.0


def test_params_count_biases_once():
    assert flops.params(SCENE) == 695_680 + sum(o for _, o, _ in flops.layers(SCENE).values())
