"""The port's editing session and GUI against the JAX ones, on the CPU.

``intrinsicnerf_tpu_torch/tools/editing.py:EditSession`` is held against
``intrinsicnerf_tpu/tools/editing.py:EditSession`` on the render
directory of ``tests/test_gui_smoke.py`` (the layout ``_save_view``
writes, with a palette the JAX ``ClusterManager`` saved) and on a render
directory and palette written by the port's scene CLI on the CPU.  Both
read the same 8-bit PNGs, so the frames, the cluster ids and every
composed edit are compared exactly; the saved PNGs by their pixels (two
encoders) and the palettes by their JSON.  ``gui.build_app`` runs
through the display-free stand-ins of ``tests/test_gui_smoke.py``.
"""

import json
import os
import types

import numpy as np
import pytest

from intrinsicnerf_tpu.tools.editing import EditSession as JSession
from intrinsicnerf_tpu_torch import gui as tgui
from intrinsicnerf_tpu_torch.tools.editing import EditSession as TSession
from intrinsicnerf_tpu_torch.utils.image import imread
from test_gui_smoke import _fake_imagetk, _fake_tk, render_dir  # noqa: F401 (a fixture)
from test_torch_scene_trainer import N_FRAMES, SPLIT, _cfg_dict, _write_cfg, tiny_replica  # noqa: F401


def _edits(s):
    """The same sequence of edits on either session; yields after each."""
    ids = s.frame_ids()
    for i in ids:
        yield "base", i, s.compose(i)
        yield "raw", i, s.compose(i, use_clusters=False)
    frame = s.load_frame(ids[0])
    for row, col in ((0, 0), (frame["label"].shape[0] // 2, frame["label"].shape[1] - 1)):
        sem, cid = s.pick(ids[0], row, col)
        if s.get_cluster_color(sem, cid) is not None:
            s.set_cluster_color(sem, cid, [0.1, 0.8, 0.3])
        yield "recolour", (row, col), s.compose(ids[0])
    s.shading_transfer = True
    s.residual_transfer = True
    s.shading_scale, s.residual_scale, s.shading_gamma = 1.5, 0.5, 2.0
    for i in ids:
        yield "transfer", i, s.compose(i)
    s.reset_palette()
    s.shading_transfer = s.residual_transfer = False
    s.shading_scale = s.residual_scale = s.shading_gamma = 1.0
    yield "reset", ids[0], s.compose(ids[0])


def _same_sessions(img_dir, cluster_dir, out):
    js = JSession(str(img_dir), str(cluster_dir))
    ts = TSession(str(img_dir), str(cluster_dir), device="cpu")
    assert ts.frame_ids() == js.frame_ids() and ts.frame_ids()
    for i in js.frame_ids():
        fj, ft = js.load_frame(i), ts.load_frame(i)
        for k in ("albedo", "shading", "residual", "label", "cluster"):
            assert fj[k].dtype == ft[k].dtype and np.array_equal(fj[k], ft[k]), (i, k)
    for (kind, at, a), (_, _, b) in zip(_edits(js), _edits(ts)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (kind, at)
    sem, cid = ts.pick(ts.frame_ids()[0], 0, 0)
    for s in (js, ts):
        if s.get_cluster_color(sem, cid) is not None:
            s.set_cluster_color(sem, cid, [0.9, 0.2, 0.6])
    j_png, t_png = out / "j.png", out / "t.png"
    js.save_edit(js.frame_ids()[0], str(j_png))
    ts.save_edit(ts.frame_ids()[0], str(t_png))
    assert np.array_equal(imread(str(j_png)), imread(str(t_png)))
    js.save_palette(str(out / "j_pal"))
    ts.save_palette(str(out / "t_pal"))
    with open(out / "j_pal" / "clusters.json") as f, open(out / "t_pal" / "clusters.json") as g:
        mj, mt = json.load(f), json.load(g)
    assert mj["class_num"] == mt["class_num"]
    assert [d is None for d in mj["cluster_dirs"]] == [d is None for d in mt["cluster_dirs"]]
    for i, d in enumerate(mj["cluster_dirs"]):
        if d is None:
            continue
        with open(out / "j_pal" / f"c{i}" / "config.json") as f:
            cj = json.load(f)
        with open(out / "t_pal" / f"c{i}" / "config.json") as g:
            ct = json.load(g)
        assert cj == ct, i
    return js, ts


def test_session_matches_jax_on_the_gui_fixture(render_dir, tmp_path):  # noqa: F811
    js, ts = _same_sessions(render_dir, render_dir / "cluster", tmp_path)
    # the fixture's two classes each have a cluster; the recolour reached one
    assert {ts.pick(0, 8, 2)[0], ts.pick(0, 8, 13)[0]} == {0, 1}
    assert (ts.load_frame(0)["cluster"] >= 0).all()
    # an edited palette saved by the port reloads into the JAX session
    again = JSession(str(render_dir), str(tmp_path / "t_pal"))
    sem, cid = ts.pick(0, 0, 0)
    np.testing.assert_array_equal(again.get_cluster_color(sem, cid),
                                  ts.get_cluster_color(sem, cid))


def test_session_matches_jax_on_a_port_scene_run(tiny_replica, tmp_path):  # noqa: F811
    """The port's scene CLI on the CPU writes a rebuild's renders and
    palette; both sessions read them alike."""
    from intrinsicnerf_tpu_torch import train_scene

    save_dir = tmp_path / "run"
    d = _cfg_dict(tiny_replica, save_dir, n_iters=8, step_vis_train=4, step_save_ckpt=8,
                  step_val=8, step_log_tfb=4, step_log_print=4)
    train_scene.main(["--config_file", _write_cfg(tmp_path, d), "--total_frames", str(N_FRAMES),
                      "--split_step", str(SPLIT), "--no_progress", "--device", "cpu"])
    render = sorted((save_dir / "train_render").glob("step_*"))[-1]
    assert (render / "cluster" / "clusters.json").exists()
    _, ts = _same_sessions(render, render / "cluster", tmp_path)
    assert any(c is not None for c in ts.manager.clusters)


def test_session_defaults_to_the_card(render_dir):  # noqa: F811
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSession(str(render_dir), str(render_dir / "cluster"))


def test_build_app_headless(render_dir):  # noqa: F811
    """The port's GUI through the stand-ins of the JAX GUI's test, with
    the same callbacks, then the recorder through the port's video
    writer."""
    tk = _fake_tk()
    app = tgui.build_app(str(render_dir), str(render_dir / "cluster"), tk=tk,
                         ImageTk=_fake_imagetk(), device="cpu")
    assert isinstance(app["session"], TSession)
    kinds = [w.kind for w in tk._created]
    assert kinds.count("Canvas") == 2 and kinds.count("Scale") == 7
    assert kinds.count("Button") == 5 and kinds.count("Checkbutton") == 2

    scale = max(1, 480 // 16)
    app["on_click"](types.SimpleNamespace(x=13 * scale, y=8 * scale))
    sem, cid = app["state"]["selected"]
    assert sem == 1 and "class 1" in app["sel_var"].get()
    for s, v in zip(app["sliders"], (255, 0, 0)):
        s.set(v)
    app["on_rgb"]()
    np.testing.assert_allclose(app["session"].get_cluster_color(sem, cid), [1.0, 0.0, 0.0],
                               atol=1 / 255)
    app["on_hls_click"](types.SimpleNamespace(x=0, y=0))
    app["on_lightness"](128)
    app["toggle_shading_transfer"]()
    app["toggle_residual_transfer"]()
    app["on_shading"](1.5)
    app["on_residual"](0.5)
    app["on_gamma"](2.0)
    assert app["session"].shading_scale == 1.5 and app["session"].shading_transfer
    app["next_frame"]()
    assert app["state"]["frame"] == 1

    app["toggle_record"]()
    app["refresh"]()
    app["next_frame"]()
    assert len(app["state"]["frames_out"]) == 2
    app["toggle_record"]()
    assert not app["state"]["recording"] and "video" in app["sel_var"].get()
    assert os.path.getsize(render_dir / "edit_session.mp4") > 0

    app["save_frame"]()
    assert np.array_equal(imread(str(render_dir / "edited_000.png")),
                          (app["session"].compose(0) * 255).astype(np.uint8))
    app["save_palette"]()
    assert (render_dir / "edited_cluster" / "clusters.json").exists()
