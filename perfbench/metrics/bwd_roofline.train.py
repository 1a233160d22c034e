"""Kernel 2's share of its roofline in training: the roofline time of
the backward's work per step (``perfbench/flops.py``) times the traced
steps, over the device time of kernel 2's passes."""

from perfbench import flops

LAYER = "ops/csrc/fused_mlp_bwd.cu (kernel 2)"
UNIT = "%"
MOVES = "train_rays_per_s"
KERNELS = ("bwd_act_wimg_kernel", "bwd_act_wgmma_kernel", "bwd_wgrad_gemm_kernel",
           "reduce_rows_kernel")


def read(run):
    s = run.summary
    if run.kind != "train" or s is None or not s.units:
        return None
    busy = s.kernel_s(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * s.units * flops.roofline_s(*flops.backward(run.arch, run.rays_per_step)) / busy
