"""Config parity: every repo config parses to the same values in the
JAX package and its PyTorch port (dtypes compared by name)."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from intrinsicnerf_tpu import config as jcfg
from intrinsicnerf_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(glob.glob(os.path.join(ROOT, "configs", "scene", "*.yaml")))
OBJECTS = sorted(glob.glob(os.path.join(ROOT, "configs", "object", "*.txt")))


def _norm(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, type):  # a jnp scalar type such as jnp.bfloat16
        return np.dtype(x).name
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def test_config_files_found():
    assert len(SCENES) >= 8 and len(OBJECTS) >= 16


@pytest.mark.parametrize(
    "path", SCENES + OBJECTS, ids=lambda p: os.path.basename(p)
)
def test_config_parity(path):
    load_j = jcfg.from_yaml if path.endswith(".yaml") else jcfg.from_object_txt
    load_t = tcfg.from_yaml if path.endswith(".yaml") else tcfg.from_object_txt
    a, b = _norm(load_j(path)), _norm(load_t(path))
    assert a == b
    assert a["mlp"]["compute_dtype"] in ("bfloat16", "float32")


def test_arith_rejects_code():
    assert tcfg._arith("32*16") == 512
    with pytest.raises(ValueError):
        tcfg._arith("__import__('os')")
