"""The port's spans and counters (``intrinsicnerf_tpu_torch/utils/trace.py``).

On the CPU: off, a span enters no profiler annotation and records
nothing; under ``trace.recording()`` nesting, parents and self time come
out right; under ``torch.profiler`` the Chrome trace holds every span
name as a ``user_annotation`` nested as documented; a tiny ``Trainer.fit``
gives one ``fit.enqueue`` a call, whose bounds ``step_hook`` gets, and
the five phase spans a step; ``render_views`` gives one ``render.view`` a
view and one ``render.chunk`` a chunk, and counts one host sync a map;
``last_rebuild`` takes its seconds from the rebuild's spans; a kernel
build (with a stand-in compiler) is a span and a counter; the benchmark's
readers of these spans return their number from a snapshot, and None
without the recorder.

On the card (``-m cuda``; the file imports no JAX, so it runs with
``--noconftest``): a graphed block's five phase times, and an eager
step's, are positive and sum to within 5% of events around the replay or
the step, and ``graph.captures`` counts captures, not replays; a graphed
block's log, written after the next replay is enqueued, holds its own
block's terms and waits once.
"""

import importlib.util
import json
import math
import os
import stat
import sys
import time

import pytest
import torch

import intrinsicnerf_tpu_torch.utils as port_utils
from intrinsicnerf_tpu_torch import config as tconfig
from intrinsicnerf_tpu_torch.cluster.assign import empty_cluster_table
from intrinsicnerf_tpu_torch.core.rays import create_rays
from intrinsicnerf_tpu_torch.models import mlp as tm
from intrinsicnerf_tpu_torch.ops import build
from intrinsicnerf_tpu_torch.render import pipeline as tp
from intrinsicnerf_tpu_torch.train import step as tstep
from intrinsicnerf_tpu_torch.train.trainer import SceneBundle, Trainer, render_views
from intrinsicnerf_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("step.sample", "step.render", "step.loss", "step.backward", "step.update")
NC, NI, PAIRS, H, W, N_IMG = 4, 4, 8, 8, 12, 3
MLP_KW = dict(depth=3, width=32, skips=(1,), n_freqs_pos=4, n_freqs_dir=2,
              pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=4)


CLOSED = []  # the spans closed in a test, oldest first


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    trace.reset()
    CLOSED.clear()
    exit_ = trace.RECORDER.exit

    def keep(s):
        exit_(s)
        CLOSED.append(s)

    monkeypatch.setattr(trace.RECORDER, "exit", keep)
    yield
    trace.reset()


def _bundle(seed=0):
    g = torch.Generator().manual_seed(seed)
    c2w = torch.eye(4).repeat(N_IMG, 1, 1)
    c2w[:, :3, 3] = torch.randn(N_IMG, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, -2.5])
    rays = create_rays(c2w, H, W, 6.0, 6.0, (W - 1) / 2, (H - 1) / 2, 0.5, 5.0)
    pools = tstep.DataPools(rays=rays, rgb=torch.rand(N_IMG, H * W, 3, generator=g), depth=None,
                            semantic=torch.randint(0, 5, (N_IMG, H * W), generator=g),
                            mask_ids=torch.ones(N_IMG, dtype=torch.long))
    return SceneBundle(pools=pools, rays_vis=rays[:2], rays_test=rays[:1], h=H, w=W, h_scaled=H,
                       w_scaled=W, num_valid_classes=4)


def _trainer(tmp_path, spc=1, cadence=10**9, n_iters=4):
    cfg = tconfig.FrameworkConfig(
        experiment=tconfig.ExperimentConfig(save_dir=str(tmp_path / "run")),
        mlp=tm.MLPConfig(**MLP_KW),
        render=tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0),
        train=tstep.TrainConfig(n_rays=PAIRS, n_iters=n_iters, steps_per_call=spc),
        chunk=40,
        logging=tconfig.LoggingConfig(step_log_tfb=cadence, step_save_ckpt=cadence,
                                      step_vis_train=cadence, step_val=cadence))
    return Trainer(cfg, _bundle(), seed=0, device="cpu")


def _named(name):
    return [s for s in CLOSED if s.name == name]


# ---- the recorder ------------------------------------------------------

def test_off_a_span_enters_no_profiler_annotation_and_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or pytest.fail("entered"))
    assert not trace.enabled()
    with trace.span("a", 1) as a:
        with trace.device_span("b", 2) as b:
            trace.count("c")
    assert a is None and b is None and entered == []
    snap = trace.snapshot()
    assert snap["spans"] == {} and CLOSED == [] and snap["counters"]["c"] == 1
    # kept always: the host interval, still no annotation
    with trace.span("cold", always=True) as cold:
        time.sleep(0.002)
    assert entered == [] and cold.seconds >= 0.002
    assert trace.snapshot()["spans"]["cold"]["count"] == 1


def test_recording_nests_spans_with_parents_and_self_time():
    with trace.recording():
        assert trace.enabled()
        with trace.span("outer", 7) as outer:
            time.sleep(0.003)
            for i in range(2):
                with trace.span("inner", i) as inner:
                    with trace.device_span("leaf"):  # no device work: a host span
                        time.sleep(0.002)
                assert inner.parent is outer
            time.sleep(0.001)
    assert not trace.enabled()
    leaves, inners = _named("leaf"), _named("inner")
    assert [s.parent for s in leaves] == inners and [s.id for s in inners] == [0, 1]
    assert outer.parent is None and outer.id == 7
    assert all(outer.t0 <= s.t0 <= s.t1 <= outer.t1 for s in inners)
    spans = trace.snapshot()["spans"]
    want_self = outer.seconds - sum(s.seconds for s in inners)
    assert spans["outer"]["count"] == 1 and math.isclose(spans["outer"]["host_s"], outer.seconds)
    assert math.isclose(spans["outer"]["self_s"], want_self, abs_tol=1e-9)
    assert 0.004 <= want_self < outer.seconds
    assert spans["inner"]["count"] == 2 and spans["leaf"]["device_n"] == 0
    assert math.isclose(spans["inner"]["self_s"],
                        spans["inner"]["host_s"] - spans["leaf"]["host_s"], abs_tol=1e-9)
    trace.reset()
    assert trace.snapshot()["spans"] == {}


def _fake_nvcc(tmp_path):
    """A compiler stand-in: writes an empty library where ``-o`` says."""
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = "-o" ]; then shift; '
                    ': > "$1"; fi\n  shift\ndone\necho "ptxas info : stand-in"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_a_kernel_build_is_a_span_and_a_cached_one_a_counter(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    path, seconds, log = build.build("fused_mlp_fwd")
    assert os.path.exists(path) and "stand-in" in log
    (built,) = _named("kernel.build")
    assert built.id == "fused_mlp_fwd" and seconds == built.seconds > 0
    assert build.build("fused_mlp_fwd")[1] == 0.0
    snap = trace.snapshot()
    assert snap["counters"]["kernel.builds"] == 1 and snap["counters"]["kernel.cache_hits"] == 1
    assert snap["spans"]["kernel.build"]["count"] == 1


# ---- the layers' spans -------------------------------------------------

def test_profiler_trace_holds_every_span_nested(tmp_path, monkeypatch):
    """Every cadence lands on step 2: log, checkpoint, rebuild, eval; a
    kernel build (stand-in compiler) in the same window."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    trainer = _trainer(tmp_path, cadence=2, n_iters=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        trainer.fit(n_iters=2, progress=False)
        build.build("fused_mlp_bwd")
    trainer.close()
    out = str(tmp_path / "trace.json")
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    nesting = {  # each span: the span it lies in
        "fit.prologue": "fit.call", "fit.enqueue": "fit.call", "fit.log": "fit.call",
        "fit.checkpoint": "fit.call", "fit.rebuild": "fit.call", "fit.eval": "fit.call",
        **{p: "fit.enqueue" for p in PHASES},
        "rebuild.render": "fit.rebuild", "rebuild.meanshift": "fit.rebuild",
        "rebuild.write": "fit.rebuild", "render.enqueue": "render.view",
        "render.chunk": "render.enqueue",
        # the rebuild's views and the evaluation's
        **{n: ("rebuild.render", "fit.eval") for n in ("render.view", "render.to_host",
                                                        "render.check")},
    }
    assert set(nesting) | {"fit.call", "kernel.build"} <= set(by)
    for child, parents in nesting.items():
        outer = [iv for p in ([parents] if isinstance(parents, str) else parents) for iv in by[p]]
        for s, t in by[child]:
            assert any(ps - 1.0 <= s and t <= pt + 1.0 for ps, pt in outer), (child, parents)
    assert len(by["fit.call"]) == 1 and len(by["fit.enqueue"]) == 2
    (ev,), (rb,) = by["fit.eval"], by["rebuild.render"]
    assert len(by["render.view"]) == 3  # two rebuild views, one test view
    assert sum(ev[0] <= s and t <= ev[1] for s, t in by["render.view"]) == 1
    assert sum(rb[0] <= s and t <= rb[1] for s, t in by["render.view"]) == 2
    assert not trace.enabled()


def test_fit_gives_one_enqueue_a_call_and_five_phases_a_step(tmp_path):
    trainer = _trainer(tmp_path, spc=2)
    bounds = []
    trainer.step_hook = lambda done, t0, t1, work: bounds.append((done, t0, t1))
    with trace.recording():
        trainer.fit(n_iters=4, progress=False)
    trainer.close()
    enqueues = _named("fit.enqueue")
    assert trainer.multi_step.k == 2 and [s.id for s in enqueues] == [2, 4]
    assert bounds == [(s.id, s.t0 * 1e-9, s.t1 * 1e-9) for s in enqueues]
    spans = trace.snapshot()["spans"]
    assert spans["fit.call"]["count"] == spans["fit.prologue"]["count"] == 1
    assert all(spans[p]["count"] == 4 for p in PHASES)
    for p in PHASES:
        assert [s.parent.name for s in _named(p)] == ["fit.enqueue"] * 4
    assert [s.id for s in _named("step.sample")] == [0, 1, 2, 3]


def test_fit_off_gives_the_hook_its_bounds_and_records_no_step(tmp_path):
    trainer = _trainer(tmp_path)
    bounds = []
    trainer.step_hook = lambda done, t0, t1, work: bounds.append((done, t1 - t0))
    trainer.fit(n_iters=2, progress=False)
    trainer.step_hook = None
    trainer.fit(n_iters=3, progress=False)
    trainer.close()
    assert [b[0] for b in bounds] == [1, 2] and all(d > 0 for _, d in bounds)
    spans = trace.snapshot()["spans"]
    assert set(spans) == {"fit.enqueue"} and spans["fit.enqueue"]["count"] == 2


def test_render_views_spans_chunks_and_host_syncs(tmp_path):
    mcfg = tm.MLPConfig(**MLP_KW)
    model = tm.IntrinsicMLP(mcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    rays = _bundle().rays_vis.repeat(2, 1, 1)[:3]
    chunk = 40
    with trace.recording():
        views = list(render_views(model, model, mcfg, tp.RenderConfig(n_coarse=NC, n_importance=NI),
                                  rays, H, W, chunk, "cpu"))
    snap = trace.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    per_view = math.ceil(H * W / chunk)
    assert [s.id for s in _named("render.view")] == [0, 1, 2]
    assert spans["render.enqueue"]["count"] == 3 and spans["render.chunk"]["count"] == 3 * per_view
    assert [s.id for s in _named("render.chunk")] == list(range(per_view)) * 3
    assert all(s.parent.name == "render.view" for s in _named("render.enqueue"))
    assert spans["render.to_host"]["count"] == spans["render.check"]["count"] == 3
    assert len(views[0]) == 9 and counters["render.views"] == 3
    assert counters["render.host_syncs"] == sum(len(v) for v in views) == 27
    # counters count with spans off too
    list(render_views(model, None, mcfg, tp.RenderConfig(n_coarse=NC, n_importance=0), rays[:1],
                      H, W, chunk, "cpu"))
    counters = trace.snapshot()["counters"]
    assert counters["render.views"] == 4 and counters["render.host_syncs"] == 36
    assert trace.snapshot()["spans"]["render.view"]["count"] == 3


def test_last_rebuild_takes_its_seconds_from_the_rebuild_spans(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.rebuild_clusters(10, save=False)
    trainer.close()
    (rendering,), (meanshift,), (write,) = (_named(n) for n in (
        "rebuild.render", "rebuild.meanshift", "rebuild.write"))
    assert trainer.last_rebuild["render_s"] == rendering.seconds > 0
    assert trainer.last_rebuild["meanshift_s"] == meanshift.seconds > 0
    assert rendering.id == meanshift.id == write.id == 10
    assert trainer.last_rebuild["views"] == 2
    assert rendering.t1 <= meanshift.t0 and meanshift.t1 <= write.t0


def test_fit_counts_its_host_syncs_at_the_log(tmp_path):
    """One wait a log: for the copies its step staged (``_stage_log``)."""
    trainer = _trainer(tmp_path, cadence=2, n_iters=4)
    trainer.fit(n_iters=4, progress=False)
    trainer.close()
    assert trace.snapshot()["counters"]["fit.host_syncs"] == 2


# ---- the benchmark's readers ------------------------------------------

READERS = {
    "step_sample_ms.train": ("train", 1.0), "step_render_ms.train": ("train", 2.0),
    "step_loss_ms.train": ("train", 0.5), "step_backward_ms.train": ("train", 6.0),
    "step_update_ms.train": ("train", 0.25), "view_gap_ms.render": ("render", 7.0),
    "view_syncs.render": ("render", 9.0),
}


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", os.path.join(ROOT, "perfbench", "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fabricated():
    steps = 16
    spans = {p: {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": ms * 1e-3 * steps,
                 "device_n": steps, "intervals_s": []}
             for p, ms in zip(PHASES, (1.0, 2.0, 0.5, 6.0, 0.25))}
    # an older pass of two views, then the newest of three: 0.3 s of render
    # kernels from its first start to its last copy's end at 0.321 s
    views = [(0, 0.0, 0.1), (1, 0.1, 0.2),
             (0, 1.0, 1.1), (1, 1.1, 1.2), (2, 1.207, 1.307)]
    copies = [(0, 0.2, 0.21), (1, 0.22, 0.25),
              (0, 1.2, 1.207), (1, 1.307, 1.314), (2, 1.3145, 1.321)]
    for name, iv in (("render.view", views), ("render.to_host", copies)):
        spans[name] = {"count": 5, "host_s": 0.1, "self_s": 0.1,
                       "device_s": sum(t - s for _, s, t in iv), "device_n": 5, "intervals_s": iv}
    return {"spans": spans, "counters": {"render.views": 12, "render.host_syncs": 108}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_the_snapshot_and_none_without_the_recorder(name, monkeypatch):
    import types

    kind, want = READERS[name]
    reader = _reader(name, monkeypatch)
    run = types.SimpleNamespace(kind=kind)
    monkeypatch.setattr(trace, "snapshot", _fabricated)
    assert math.isclose(reader.read(run), want, rel_tol=1e-9)
    other = types.SimpleNamespace(kind="render" if kind == "train" else "train")
    assert reader.read(other) is None
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert reader.read(run) is None
    # the parent commit: no recorder in the program
    monkeypatch.delattr(port_utils, "trace")
    monkeypatch.setitem(sys.modules, "intrinsicnerf_tpu_torch.utils.trace", None)
    assert reader.read(run) is None


# ---- on the card -------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphed step's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _replica_step():
    """Replica widths (C = 27, bf16 kernels), 1,024 rays: the step, its
    state and inputs on the card."""
    c, h, w = 27, 24, 32
    cfg = tm.MLPConfig(pos_scalar_factor=10.0, enable_semantic=True, num_semantic_classes=c,
                       compute_dtype=torch.bfloat16, use_fused_kernel=True)
    c2w = torch.eye(4, device="cuda").repeat(2, 1, 1)
    c2w[:, 2, 3] = torch.tensor([-1.0, -1.3])
    rays = create_rays(c2w, h, w, 16.0, 16.0, 15.5, 11.5, 0.1, 10.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pools = tstep.DataPools(rays=rays, rgb=torch.rand(2, h * w, 3, device="cuda", generator=gen),
                            semantic=torch.randint(0, c + 1, (2, h * w), device="cuda",
                                                   generator=gen),
                            mask_ids=torch.ones(2, dtype=torch.int32, device="cuda"))
    tcfg = tstep.TrainConfig(n_rays=1024)
    state = tstep.create_train_state(cfg, tcfg, device="cuda")
    step = tstep.make_train_step(cfg, tp.RenderConfig(perturb=1.0, raw_noise_std=1.0), tcfg, h, w)
    table = empty_cluster_table(c, 64, device="cuda")
    return step, state, pools, table, torch.tensor(0.1, device="cuda"), gen, c


def _phases_against_events(run):
    """The phases' device seconds and ``run``'s, from events around it
    (spans on)."""
    around = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with trace.recording():
        around[0].record()
        run()
        around[1].record()
    torch.cuda.synchronize()
    spans = trace.snapshot()["spans"]
    return spans, around[0].elapsed_time(around[1]) * 1e-3


@pytest.mark.cuda
def test_graphed_block_times_its_phases(card):
    """4 steps a block."""
    k = 4
    step, state, pools, table, w_c, gen, c = _replica_step()
    multi = tstep.make_multi_step(step, k)
    multi(state, pools, table, w_c, gen)  # captured and replayed with spans off
    multi(state, pools, table, w_c, gen)
    torch.cuda.synchronize()
    counters = trace.snapshot()["counters"]
    captures = counters["graph.captures"]
    assert trace.snapshot()["spans"] == {} and counters["graph.replays"] >= 2
    assert counters["graph.stamp_nodes"] == 2 * len(PHASES) * k * captures
    spans, whole = _phases_against_events(lambda: multi(state, pools, table, w_c, gen))
    times = [spans[p]["device_s"] for p in PHASES]
    assert all(spans[p]["device_n"] == k for p in PHASES) and all(t > 0 for t in times)
    assert abs(sum(times) - whole) <= 0.05 * whole, (times, whole)
    assert trace.snapshot()["counters"]["graph.captures"] == captures
    multi(state, pools, empty_cluster_table(c, 64, device="cuda"), w_c, gen)  # a new table tensor
    assert trace.snapshot()["counters"]["graph.captures"] == captures + 1


@pytest.mark.cuda
def test_eager_step_stamps_its_phases(card):
    """One eager step: one device interval a phase, in the step's order,
    summing within 5% of events around the step."""
    step, state, pools, table, w_c, gen, _ = _replica_step()
    step(state, pools, table, w_c, gen)  # spans off: the kernels built and loaded
    torch.cuda.synchronize()
    assert trace.snapshot()["spans"] == {}
    spans, whole = _phases_against_events(lambda: step(state, pools, table, w_c, gen))
    times = [spans[p]["device_s"] for p in PHASES]
    assert all(spans[p]["device_n"] == 1 for p in PHASES) and all(t > 0 for t in times)
    starts = [spans[p]["intervals_s"][0][1] for p in PHASES]
    assert starts == sorted(starts)
    assert abs(sum(times) - whole) <= 0.05 * whole, (times, whole)


class _Recorded:
    """A trainer's multi-step that records each block's total (a sync of
    the test's own) and passes the rest through."""

    def __init__(self, multi, seen):
        self.multi, self.seen, self.k = multi, seen, multi.k

    def __getattr__(self, name):
        return getattr(self.multi, name)

    def __call__(self, state, *args):
        report = self.multi(state, *args)
        self.seen[state.step] = float(report.total)
        return report


@pytest.mark.cuda
def test_a_staged_log_reads_its_own_block_on_the_card(card, tmp_path):
    """``fit`` writes a block's log once the next replay is enqueued: its
    row holds that block's terms, though the replay rewrites the graph's
    outputs, and the log waits once."""
    k, n = 4, 12
    cfg = tconfig.FrameworkConfig(
        experiment=tconfig.ExperimentConfig(save_dir=str(tmp_path / "run")),
        mlp=tm.MLPConfig(**MLP_KW),
        render=tp.RenderConfig(n_coarse=NC, n_importance=NI, perturb=1.0, raw_noise_std=1.0),
        train=tstep.TrainConfig(n_rays=PAIRS, n_iters=n, steps_per_call=k), chunk=40,
        logging=tconfig.LoggingConfig(step_log_tfb=k, step_save_ckpt=10**9,
                                      step_vis_train=10**9, step_val=10**9))
    b = _bundle()
    bundle = SceneBundle(
        pools=tstep.DataPools(*(None if t is None else t.cuda() for t in b.pools)),
        rays_vis=b.rays_vis.cuda(), rays_test=b.rays_test.cuda(), h=H, w=W, h_scaled=H,
        w_scaled=W, num_valid_classes=4)
    trainer = Trainer(cfg, bundle, seed=0, device="cuda")
    seen = {}
    trainer.multi_step = _Recorded(tstep.make_multi_step(trainer.step_fn, k), seen)
    trainer.fit(n_iters=n, progress=False)
    trainer.close()
    with open(os.path.join(cfg.experiment.save_dir, "tfb_logs", "scalars.csv")) as f:
        logged = {int(r[0]): float(r[2]) for r in (line.rstrip("\n").split(",") for line in f)
                  if r[1] == "Train/Loss/total"}
    assert sorted(logged) == [4, 8, 12] and len(set(seen.values())) == 3
    assert logged == seen
    assert trace.snapshot()["counters"]["fit.host_syncs"] == 3
