"""The port's kernel bench (``tools/kernel_bench.py``, twin of
``tools_kernel_bench.py``) on the CPU, through the kernels' plain
versions at a tiny size: its rows' fields and bounds, its copy of
``chip_smoke.py:fused_work``, and the graphed step's row (a loop of K
steps on the host)."""

import math

import pytest
import torch

import chip_smoke
from intrinsicnerf_tpu_torch.models.mlp import MLPConfig, PackedMLP
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
from intrinsicnerf_tpu_torch.tools import bench, kernel_bench
from intrinsicnerf_tpu_torch.tools.bwd_passes import backward_macs
from intrinsicnerf_tpu_torch.train.step import TrainConfig

TINY = MLPConfig(depth=8, width=32, skips=(4,), pos_scalar_factor=10.0, enable_semantic=True,
                 num_semantic_classes=5, compute_dtype=torch.bfloat16, use_fused_kernel=True)


@pytest.mark.parametrize("args", [(1, 10, 100, 3), (65_536, 695_680, 835_584, 2_944),
                                  (196_608, 659_456, 835_584, 2_944)])
def test_fused_work_is_the_smoke_scripts(args):
    assert kernel_bench.fused_work(*args) == chip_smoke.fused_work(*args)


def test_kernel_rows_on_the_plain_versions():
    model = PackedMLP(TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    rows = kernel_bench.kernel_rows(model, TINY, (("a", 64), ("b", 100)), iters=1)
    macs = sum(v.numel() for k, v in model.state_dict().items() if k.endswith(".weight"))
    bwd = sum(backward_macs(model).values())
    for (label, n), row in zip((("a", 64), ("b", 100)), rows.values()):
        assert row["points"] == n
        f = kernel_bench.fused_work(n, macs, model.weight.numel(), model.bias.numel())
        b = kernel_bench.backward_work(n, bwd, model.weight.numel(), model.bias.numel())
        assert (row["fwd_bound_ms"], row["fwd_bound_by"]) == kernel_bench.bound(*f)
        assert (row["fwd_bwd_bound_ms"], row["fwd_bwd_bound_by"]) == kernel_bench.bound(
            f[0] + b[0], f[1] + b[1])
        assert row["fwd_ms"] > 0 and row["fwd_bwd_ms"] > 0
        assert math.isclose(row["fwd_tflops"], f[0] / row["fwd_ms"] / 1e9)
    assert model.weight.grad is not None and torch.isfinite(model.weight.grad).all()


def test_step_row_on_the_host():
    rcfg = RenderConfig(n_coarse=4, n_importance=4, perturb=1.0, raw_noise_std=1.0)
    workload = bench.make_workload("cpu", 0, TINY, rcfg, TrainConfig(n_rays=8), 8, 8, 2)
    row = kernel_bench.step_row(workload, 2, 4, 1.5)
    assert row["steps_per_call"] == 2 and row["bound_ms"] == 1.5
    assert row["ms_per_step"] > 0 and math.isfinite(row["last_total"])
    assert row["spread"]["windows"] == 3 and row["spread"]["steps_per_window"] == 4
