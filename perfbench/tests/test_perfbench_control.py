"""The control of ``correct`` on the card, at each cell's own size: the
reference in float8 put in the program's place fails one of the cell's
numbers, and so does each fault a training cell can have.  Card only
(``-m cuda``); the readings the limits were set from came from
``python3 -m perfbench.control`` over three seeds."""

import shutil

import pytest
import torch

from perfbench import control
from perfbench import run as harness

SEED = 2147484999


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cells' own sizes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.keep_jax_out()


def failed(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]])
def test_the_control_and_the_faults_fail(card, workload):
    bench = harness.Bench(workload, SEED, 1.0, False, "cuda")
    try:
        train = bench.traffic["driver"] == "train"
        readings = (control.train_readings if train else control.render_readings)(bench)
    finally:
        shutil.rmtree(bench.workdir, ignore_errors=True)
    assert failed(readings["float8"], bench.limits), readings
    assert not failed(readings["bfloat16"], bench.limits), readings
    faults = (("half_batch", "unchanged") + (("empty_table",) if "table" in bench.limits else ())
              if train else ("half_batch", "altered", "tail"))
    for fault in faults:
        assert failed(readings[fault], bench.limits), (fault, readings)
