"""Whole runs on the host with the timed path broken underneath: each
fault a cell can have must turn ``correct`` false, and the sound run
must stay true.  (A one-chip cell has no exchange between chips to
leave out.)"""

import pytest
import torch

from perfbench import run as harness
from tiny import tiny_bench

def run(workload, seed=2147483711):
    return harness.run_cell(tiny_bench(workload, seed))


def half(batch):
    """A RayBatch with half of its pairs, the mean then taken over those."""
    n = batch.rays.shape[0] // 2
    keep = torch.cat([torch.arange(n // 2), torch.arange(n, n + n // 2)])
    return batch._replace(**{f: getattr(batch, f)[keep] for f in ("rays", "rgb", "depth",
                                                                      "semantic")
                             if getattr(batch, f) is not None})


@pytest.mark.parametrize("workload", ["replica_room_0.train", "lego.train"])
def test_sound_training_run_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", ["replica_room_0.train", "lego.train"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "empty_table"])
def test_training_faults_are_caught(workload, fault, monkeypatch):
    from intrinsicnerf_tpu_torch.cluster import manager as port_manager
    from intrinsicnerf_tpu_torch.train import step as port_step
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    if fault == "empty_table":  # the rebuild installs a table with no clusters
        real_table = port_manager.ClusterManager.to_table

        def empty(self, *a, **k):
            t = real_table(self, *a, **k)
            return t._replace(has_cluster=torch.zeros_like(t.has_cluster))

        monkeypatch.setattr(port_manager.ClusterManager, "to_table", empty)
    elif fault == "unchanged":  # the step returns its state unchanged
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        if workload.startswith("lego"):
            real = port_trainer.sample_ray_pairs_from_poses
            monkeypatch.setattr(port_trainer, "sample_ray_pairs_from_poses",
                                lambda *a, **k: half(real(*a, **k)))
        else:
            real = port_step.sample_ray_pairs
            monkeypatch.setattr(port_step, "sample_ray_pairs", lambda *a, **k: half(real(*a, **k)))
    else:  # the photometric loss altered where it is produced
        real = port_step.img2mse
        monkeypatch.setattr(port_step, "img2mse", lambda x, y: 1.1 * real(x, y))
    assert not run(workload)["correct"]


def test_sampler_stuck_in_its_warm_up_is_caught(monkeypatch):
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    real = port_trainer.sample_ray_pairs_from_poses
    monkeypatch.setattr(port_trainer, "sample_ray_pairs_from_poses",
                        lambda *a, **k: real(*a, **dict(k, precrop_iters=1 << 30)))
    assert not run("lego.train")["correct"]


@pytest.mark.parametrize("workload", ["replica_room_0.render", "lego.render"])
def test_sound_render_run_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", ["replica_room_0.render", "lego.render"])
@pytest.mark.parametrize("fault", ["half_batch", "tail", "altered"])
def test_render_faults_are_caught(workload, fault, monkeypatch):
    from intrinsicnerf_tpu_torch.train import trainer as port_trainer

    if fault in ("half_batch", "tail"):  # half, or the last 5%, of a view's rays left out
        real = port_trainer.render_rays_chunked

        def zeros_past(t, keep):
            return None if t is None else torch.cat([t[:keep], torch.zeros_like(t[keep:])])

        def halved(mc, mf, cfg, rays, rcfg, chunk):
            out = real(mc, mf, cfg, rays, rcfg, chunk)
            n = rays.shape[0]
            keep = n // 2 if fault == "half_batch" else n - n // 20
            return type(out)(*[type(f)(*[zeros_past(t, keep) for t in f])
                               if isinstance(f, tuple) else zeros_past(f, keep) for f in out])

        monkeypatch.setattr(port_trainer, "render_rays_chunked", halved)
    else:  # each view's colour altered where it is produced
        real = port_trainer._views

        def altered(*a, **k):
            for view in real(*a, **k):
                yield dict(view, rgb=view["rgb"][..., ::-1].copy())

        monkeypatch.setattr(port_trainer, "_views", altered)
    assert not run(workload)["correct"]
