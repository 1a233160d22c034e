"""Kernel 1's share of its roofline in rendering: the roofline time of
the forward's work per view (``perfbench/flops.py``) times the traced
views, over the device time of kernel 1 and its weight image."""

from perfbench import flops

LAYER = "ops/csrc/fused_mlp_fwd.cu (kernel 1 and its weight image)"
UNIT = "%"
MOVES = "view_ms"
KERNELS = ("fused_mlp_fwd_kernel", "fwd_wimg_kernel")


def read(run):
    s = run.summary
    if run.kind != "render" or s is None or not s.units:
        return None
    busy = s.kernel_s(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * s.units * flops.roofline_s(*flops.forward(run.arch, run.rays_per_view)) / busy
