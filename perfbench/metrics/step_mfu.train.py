"""The whole training step's share of the card's bf16 peak: the
network's forward and backward FLOP per step (``perfbench/flops.py``)
times the steps of the window, over the window, over 989 TFLOP/s."""

from perfbench import flops

LAYER = "train/step.py"
UNIT = "%"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    step = flops.forward(run.arch, run.rays_per_step)[0] + flops.backward(run.arch,
                                                                          run.rays_per_step)[0]
    return 100.0 * step * run.steps / run.window_s / flops.PEAK_BF16_FLOPS
