"""Guards of the PyTorch port: what it may import, where its state goes,
and that its kernel module needs no compiler until a kernel launches."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import intrinsicnerf_tpu_torch
from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.ops import build, fused_mlp
from intrinsicnerf_tpu_torch.render.pipeline import RenderConfig
from intrinsicnerf_tpu_torch.tools.import_ckpt import params_from_jax, params_to_jax
from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table, table_from_numpy
from intrinsicnerf_tpu_torch.train.step import TrainConfig, create_train_state
from intrinsicnerf_tpu_torch.train.trainer import render_views

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    glob.glob(os.path.join(ROOT, "intrinsicnerf_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "intrinsicnerf_tpu")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    assert os.path.exists(path)
    for name in _imported_roots(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def _tiny():
    return MLPConfig(depth=4, width=32, skips=(2,))


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_defaults_to_cuda_and_raises(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IntrinsicMLP(_tiny())
    assert next(IntrinsicMLP(_tiny(), device="cpu").parameters()).device.type == "cpu"


def test_weight_carry_over_defaults_to_cuda_and_raises(no_gpu):
    tree = params_to_jax(IntrinsicMLP(_tiny(), device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree)
    assert params_from_jax(tree, device="cpu")["pts_linears.0.weight"].device.type == "cpu"


def test_render_views_defaults_to_cuda_and_raises(no_gpu):
    cfg = _tiny()
    m = IntrinsicMLP(cfg, device="cpu")
    rays = np.zeros((1, 4, 11), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_views(m, m, cfg, RenderConfig(n_coarse=4, n_importance=4), rays, 2, 2, 4)


def test_train_state_defaults_to_cuda_and_raises(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(_tiny(), TrainConfig())
    state = create_train_state(_tiny(), TrainConfig(), device="cpu")
    assert next(state.model_fine.parameters()).device.type == "cpu"
    assert len(state.optimizer.param_groups[0]["params"]) == 2 * len(
        list(state.model_coarse.parameters()))


def test_cluster_tables_default_to_cuda_and_raise(no_gpu):
    per_class = [None, (np.zeros((2, 3)), np.zeros(2), np.full((1, 3), 0.5))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        empty_cluster_table(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_from_numpy(per_class)
    assert table_from_numpy(per_class, 4, device="cpu").has_cluster.tolist() == [False, True]


def test_resolve_device_cpu_is_explicit(no_gpu):
    assert intrinsicnerf_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        intrinsicnerf_tpu_torch.resolve_device("cuda")


def test_kernel_wrapper_refuses_other_devices():
    cfg = MLPConfig(pos_scalar_factor=10.0)
    ops = IntrinsicMLP(cfg, device="cpu").fused_operands(cfg)
    in8 = torch.zeros(4, fused_mlp.IN8_W, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.fused_mlp_forward(ops, in8)


def test_kernel_module_imports_without_nvcc(tmp_path):
    """A fresh interpreter with no nvcc anywhere imports the kernel module
    and builds nothing; only the build at a kernel's first launch needs nvcc."""
    code = (
        "import intrinsicnerf_tpu_torch.ops.fused_mlp as fm, "
        "intrinsicnerf_tpu_torch.ops.build as b\n"
        "assert not b._loaded\n"
        "try:\n    b.nvcc_path()\nexcept RuntimeError as e:\n    print('no nvcc:', e)\n"
        "else:\n    raise SystemExit('nvcc unexpectedly found')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc" in proc.stdout


def test_build_paths_stay_in_the_package():
    for name in build.SIGNATURES:
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR + os.sep)
        assert os.path.exists(os.path.join(build.CSRC, f"{name}.cu"))
    assert os.path.dirname(build.BUILD_DIR) == os.path.dirname(os.path.dirname(fused_mlp.__file__))
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
