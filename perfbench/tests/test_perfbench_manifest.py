"""``BENCHMARK.json`` and the files it names: found by name, within the
contract's limits, and extended by adding files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from perfbench import run as harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"setup_s", "train_rays_per_s", "view_ms", "view_ms.p90"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], w)
    for w in bench["workloads"]:
        assert harness.applies(e2e["setup_s"], w["name"])
        reported = [m for m in bench["end_to_end"] if harness.applies(m, w["name"])]
        assert len(reported) >= 2 and w["chips"] == 1
        assert any(harness.applies(m, w["name"]) for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert harness.data_file("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        traffic = harness.data_file("traffic", w["traffic"])
        assert hasattr(harness.code_file("drivers", traffic["driver"]), "run")
        assert harness.data_file("limits", w["name"])
    for m in bench["per_layer"]:
        module = harness.code_file("metrics", m["name"])
        assert module.UNIT == m["unit"] and module.MOVES == m["moves"]
        assert module.LAYER == m["layer"]


def test_a_new_cell_is_files_alone(tmp_path, bench):
    """A configuration, a traffic mix with its driver, and a per-layer
    metric added as new files and entries, then run without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "toy", "source": "https://example.org/toy",
                           "file": "perfbench/configs/toy.json", "reduced": [], "why": "toy"})
    new["workloads"].append({"name": "toy.count", "config": "toy", "traffic": "count",
                             "chips": 1, "why": "toy"})
    new["end_to_end"].append({"name": "counted_per_s", "unit": "1/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock", "workloads": ["toy.count"]})
    new["per_layer"].append({"name": "counted_share.count", "unit": "%", "better": "higher",
                             "source": "program_counter", "layer": "toy", "moves": "counted_per_s",
                             "workloads": ["toy.count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    (root / "perfbench/configs/toy.json").write_text(json.dumps({"name": "toy", "n": 7}))
    (root / "perfbench/traffic/count.json").write_text(json.dumps({"driver": "count"}))
    (root / "perfbench/limits/toy.count.json").write_text(json.dumps({"off_by": 0}))
    (root / "perfbench/drivers/count.py").write_text(
        "import time, types\n"
        "def run(bench):\n"
        "    n = bench.config['n']\n"
        "    rec = types.SimpleNamespace(n=n, summary=None)\n"
        "    return {'t_window': time.perf_counter(), 'attempted': n, 'failed': 0,\n"
        "            'e2e': {'counted_per_s': float(n)}, 'checks': {'off_by': 0},\n"
        "            'memory_peak_bytes': 0, 'record': rec}\n")
    (root / "perfbench/metrics/counted_share.count.py").write_text(
        "LAYER = 'toy'\nUNIT = '%'\nMOVES = 'counted_per_s'\nKERNELS = ()\n"
        "def read(run):\n    return 100.0 * run.n / 7\n")
    plain = harness.run_cell(harness.Bench("toy.count", 1, 1.0, False, "cpu", root=str(root)))
    traced = harness.run_cell(harness.Bench("toy.count", 1, 1.0, True, "cpu", root=str(root)))
    assert plain["correct"] and set(plain["metrics"]) == {"counted_per_s", "setup_s"}
    assert traced["metrics"] == {"counted_share.count": {"value": 100.0, "unit": "%"}}
    assert list(plain)[-1] == "checks"


def test_the_harness_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "replica_room_0.train", "--seed", "3", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_the_harness_refuses_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result, non-zero."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                           "lego.render", "--seed", "2147483999", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_are_compared_by_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "intrinsicnerf_tpu_torch_fake", types.ModuleType("x"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "intrinsicnerf_tpu.ops", types.ModuleType("y"))
    assert harness.loaded_forbidden() == ["intrinsicnerf_tpu"]
