"""The forward-facing cell in NDC (``fern.train_ndc``) in whole runs on the
host: the sound run is ``correct``, and each fault it can have, planted
underneath the timed path, turns ``correct`` false.  The NDC faults are
the two the projection invites: the focal of the full-size images (8x at
``factor`` 8, as a loader that does not scale it gives) and the
projection left out."""

import pytest
import torch

from perfbench import run as harness
from test_perfbench_faults import half
from tiny import tiny_bench

CELL = "fern.train_ndc"


def run(seed=2147483711):
    return harness.run_cell(tiny_bench(CELL, seed))


@pytest.mark.parametrize("seed", [2147483711, 3000000019])
def test_sound_run_is_correct(seed):
    result = run(seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss", "grad", "change", "table", "rays"}


@pytest.mark.parametrize("fault", ["half_batch", "unchanged", "empty_table", "focal_8x",
                                   "no_ndc"])
def test_faults_are_caught(fault, monkeypatch):
    from intrinsicnerf_tpu_torch import train_object as port_cli
    from intrinsicnerf_tpu_torch.cluster import manager as port_manager
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    if fault == "half_batch":
        real = port_trainer.sample_ray_pairs_from_poses
        monkeypatch.setattr(port_trainer, "sample_ray_pairs_from_poses",
                            lambda *a, **k: half(real(*a, **k)))
    elif fault == "unchanged":  # the step returns its state unchanged
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "empty_table":  # the rebuild installs a table with no clusters
        real_table = port_manager.ClusterManager.to_table

        def empty(self, *a, **k):
            t = real_table(self, *a, **k)
            return t._replace(has_cluster=torch.zeros_like(t.has_cluster))

        monkeypatch.setattr(port_manager.ClusterManager, "to_table", empty)
    else:  # the NDC focal of the full-size images, or none: no projection
        real_focal = port_cli.ndc_focal_for
        monkeypatch.setattr(port_cli, "ndc_focal_for",
                            lambda cfg, data: (8.0 * real_focal(cfg, data)
                                               if fault == "focal_8x" else None))
    result = run()
    assert not result["correct"], result["checks"]
    if fault in ("focal_8x", "no_ndc"):
        assert result["checks"]["rays"]["value"] > result["checks"]["rays"]["limit"]
