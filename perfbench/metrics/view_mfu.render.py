"""The whole view's share of the card's bf16 peak: the network's forward
FLOP per view (``perfbench/flops.py``) times the views of the window,
over the window, over 989 TFLOP/s."""

from perfbench import flops

LAYER = "render/pipeline.py"
UNIT = "%"
MOVES = "view_ms"
KERNELS = ()


def read(run):
    if run.kind != "render" or not run.views:
        return None
    view = flops.forward(run.arch, run.rays_per_view)[0]
    return 100.0 * view * run.views / run.window_s / flops.PEAK_BF16_FLOPS
