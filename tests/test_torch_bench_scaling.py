"""The port's weak-scaling bench (``tools/bench_scaling.py``, twin of
``bench_scaling.py``) and its stamp (``tools/stamp_scaling.py``, twin of
``tools_stamp_scaling.py``), on the CPU.

- The gloo rig at one and two rank processes (the JAX tool's CPU config,
  one step a call): each row's fields, finite rates that agree with its
  ms per step, and one gradient and one loss-term all-reduce a step, as
  the data-parallel step makes.  Each rig has a hard time limit that
  kills its ranks.
- More ranks than the host can run are refused, naming the count.
- The efficiency column and the stamp's JSON from given rows.
"""

import json
import math
import os

import pytest

from intrinsicnerf_tpu_torch.tools import bench_scaling, stamp_scaling

RIG_TIMEOUT_S = 180


@pytest.mark.parametrize("world", [1, 2])
def test_gloo_rig_rows(world, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the ranks share 2 threads of a busy host
    row = bench_scaling.spawn_rig(world, "cpu", None, 10, 0, timeout=RIG_TIMEOUT_S)
    assert (row["world"], row["backend"], row["steps_per_call"], row["pairs_per_rank"]) == (
        world, "gloo", 1, 64)
    assert row["collective_calls_per_replay"] == {"reduce_grads": 1.0, "reduce_terms": 1.0}
    assert row["nccl_device_ms_per_step"] is None  # no NCCL on the host
    assert math.isfinite(row["last_total"]) and row["ms_per_step"] > 0
    assert math.isclose(row["steps_per_s"], 1e3 / row["ms_per_step"])
    assert math.isclose(row["global_rays_per_s"], 2 * 64 * world * row["steps_per_s"],
                        rel_tol=1e-9)
    assert row["spread"]["windows"] == 5 and row["spread"]["steps_per_window"] == 10


def test_more_ranks_than_the_host_has_are_refused():
    n = os.cpu_count() + 1
    with pytest.raises(SystemExit, match=f"asked for {n} ranks; this host has {n - 1} CPU"):
        bench_scaling.main(["--device", "cpu", "--ranks", "1", str(n)])


def _fake_rows(monkeypatch):
    calls = []

    def spawn(world, device, n_rays, iters, seed, timeout=bench_scaling.RIG_TIMEOUT_S):
        calls.append((world, device, n_rays, iters, seed))
        return {"world": world, "backend": "gloo", "ms_per_step": 10.0 * (1 + 0.25 * (world - 1))}

    monkeypatch.setattr(bench_scaling, "spawn_rig", spawn)
    return calls


def test_efficiency_is_against_the_smallest_world(monkeypatch, capsys):
    calls = _fake_rows(monkeypatch)
    result = bench_scaling.main(["--device", "cpu", "--ranks", "2", "4"])
    assert calls == [(2, "cpu", None, 10, 0), (4, "cpu", None, 10, 0)]
    assert result["efficiency_baseline_ranks"] == 2
    assert result["results"][2]["weak_scaling_efficiency"] == 1.0
    assert result["results"][4]["weak_scaling_efficiency"] == pytest.approx(12.5 / 17.5)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["backend"] == "gloo"


def test_stamp_writes_the_rig_row_with_its_caveat(monkeypatch, tmp_path):
    _fake_rows(monkeypatch)
    out = tmp_path / "scaling.json"
    stamp_scaling.main(["--skip-card", "--out", str(out)])
    got = json.loads(out.read_text())
    rig = got["cpu_2process_rig"]
    assert "card" not in got and rig["caveat"] == stamp_scaling.CAVEAT
    assert sorted(rig["results"]) == ["1", "2"] and rig["efficiency_baseline_ranks"] == 1
