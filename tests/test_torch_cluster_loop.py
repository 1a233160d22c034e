"""The host side of the port's cluster loop and its metrics against the
JAX package: the same numpy inputs through both.

- The metrics are numpy in both packages: equal exactly.
- Mean-shift is exact between the packages only when both take the same
  path, so each comparison pins one: numpy in both, or the first-party
  C++ (each package's own build of ``native/intrinsic_native.cpp``) in
  both.  Then ``estimate_bandwidth``, ``mean_shift``, ``build_cluster``
  and ``ClusterManager`` are equal exactly.  The C++ bandwidth estimate
  is an OpenMP reduction whose partial sums combine in the order the
  threads finish, so the native comparisons run it on one thread.
- The palette files are one format: each package loads the other's.
- ``dest_color_chunked`` picks the same anchor as JAX for every point
  (the argmin of fp32 scores summed in another order could tie-break
  differently, so the inputs keep a margin), so the colours are equal.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from intrinsicnerf_tpu.cluster import assign as ja
from intrinsicnerf_tpu.cluster import manager as jmgr
from intrinsicnerf_tpu.cluster import meanshift as jms
from intrinsicnerf_tpu.core import metrics as jmet
from intrinsicnerf_tpu_torch import native as tnative
from intrinsicnerf_tpu_torch.cluster import assign as ta
from intrinsicnerf_tpu_torch.cluster import manager as tmgr
from intrinsicnerf_tpu_torch.cluster import meanshift as tms
from intrinsicnerf_tpu_torch.core import metrics as tmet


@pytest.fixture(params=["numpy", "native"])
def path(request, monkeypatch):
    """Pin one mean-shift path in both packages."""
    if request.param == "numpy":
        monkeypatch.setattr(jms, "_NATIVE", None)
        monkeypatch.setattr(tms, "_native", lambda: None)
    else:
        assert jms._NATIVE is not None, "the JAX package's native build is missing"
        assert tnative.native_available(), "the port's native build failed"
        gomp = ctypes.CDLL("libgomp.so.1")  # the OpenMP runtime both libraries use
        threads = gomp.omp_get_max_threads()
        gomp.omp_set_num_threads(1)
        request.addfinalizer(lambda: gomp.omp_set_num_threads(threads))
    assert tms.backend() == request.param
    return request.param


def _albedo_pixels(rng, n=3000, k=5):
    """Albedo-like pixels around ``k`` colours, a few of them empty (0)."""
    centers = rng.uniform(0.1, 0.9, size=(k, 3))
    px = centers[rng.integers(0, k, n)] + rng.normal(size=(n, 3)) * 0.02
    px[:7] = 0.0  # empty rays: dropped by build_cluster
    return np.clip(px, 0, 1).astype(np.float32)


def test_segmentation_and_depth_metrics_equal_jax(rng):
    n_cls = 6
    t = rng.integers(-1, n_cls, size=(3, 20, 30))
    p = rng.integers(0, n_cls, size=(3, 20, 30))
    got = tmet.calculate_segmentation_metrics(t, p, n_cls, ignore_label=-1)
    ref = jmet.calculate_segmentation_metrics(t, p, n_cls, ignore_label=-1)
    assert got[:4] == ref[:4]
    np.testing.assert_array_equal(got[4], ref[4])
    void = tmet.calculate_segmentation_metrics(np.full(5, -1), np.zeros(5), 3)
    assert void[:4] == (0.0,) * 4 and not void[4].any()  # all void: zeros, as JAX
    np.testing.assert_array_equal(tmet.confusion_matrix(t[t >= 0], p[t >= 0], n_cls),
                                  jmet.confusion_matrix(t[t >= 0], p[t >= 0], n_cls))
    gt_d = rng.uniform(0.2, 12.0, size=(2, 10, 12)).astype(np.float32)
    pred_d = gt_d * rng.uniform(0.8, 1.25, size=gt_d.shape).astype(np.float32)
    pred_d[0, 0, :3] = 0.0
    assert tmet.calculate_depth_metrics(gt_d, pred_d) == jmet.calculate_depth_metrics(gt_d, pred_d)
    a, b = rng.uniform(size=(8, 8, 3)), rng.uniform(size=(8, 8, 3))
    assert tmet.psnr_np(a, b) == jmet.psnr_np(a, b)
    assert tmet.psnr_np(a, a) == float("inf")


def test_bandwidth_and_mean_shift_equal_jax(rng, path):
    d = tmgr.map_drgb_np(_albedo_pixels(rng)[7:].astype(np.float64))
    assert tms.estimate_bandwidth(d, n_samples=1000) == jms.estimate_bandwidth(d, n_samples=1000)
    bw = max(jms.estimate_bandwidth(d) * 0.5, 0.01)
    c_t, l_t = tms.mean_shift(d, bw)
    c_j, l_j = jms.mean_shift(d, bw)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(l_t, l_j)
    assert len(c_t) >= 3


def test_build_cluster_and_manager_equal_jax(rng, path):
    px = _albedo_pixels(rng)
    a, b = tmgr.build_cluster(px, band_factor=0.4), jmgr.build_cluster(px, band_factor=0.4)
    for k in ("anchors", "links", "rgb_centers"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    labels = rng.integers(0, 4, len(px))
    labels[labels == 2] = 3  # class 2 empty: no clusters
    mt, mj = tmgr.ClusterManager(class_num=4), jmgr.ClusterManager(class_num=4)
    mt.update_centers(labels, px, band_factor=0.3)
    mj.update_centers(labels, px, band_factor=0.3)
    assert [c is None for c in mt.clusters] == [c is None for c in mj.clusters] == [
        False, False, True, False]
    for ct, cj in zip(mt.clusters, mj.clusters):
        if ct is not None:
            for k in ("anchors", "links", "rgb_centers"):
                np.testing.assert_array_equal(getattr(ct, k), getattr(cj, k))
    tt, tj = mt.to_table(256, device="cpu"), mj.to_table(256)
    for k in ("anchors", "colors", "links", "has_cluster"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(tj, k)))


def _same_manager(a, b):
    assert a.class_num == b.class_num and len(a.clusters) == len(b.clusters)
    for ca, cb in zip(a.clusters, b.clusters):
        assert (ca is None) == (cb is None)
        if ca is not None:
            for k in ("anchors", "links", "rgb_centers"):
                np.testing.assert_array_equal(getattr(ca, k), getattr(cb, k))
            assert (ca.intensity_factor, ca.batch_size) == (cb.intensity_factor, cb.batch_size)


def test_palette_files_load_across_packages(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(jms, "_NATIVE", None)
    monkeypatch.setattr(tms, "_native", lambda: None)
    px = _albedo_pixels(rng, n=1200)
    labels = rng.integers(0, 3, len(px))
    labels[labels == 1] = 0
    mt = tmgr.ClusterManager(class_num=3)
    mt.update_centers(labels, px)
    mt.save(str(tmp_path / "port"))
    _same_manager(jmgr.ClusterManager.load(str(tmp_path / "port")), mt)
    mj = jmgr.ClusterManager(class_num=3)
    mj.update_centers(labels, px)
    mj.save(str(tmp_path / "jax"))
    back = tmgr.ClusterManager.load(str(tmp_path / "jax"))
    _same_manager(back, mj)
    assert sorted(p.name for p in (tmp_path / "port").rglob("*")) == sorted(
        p.name for p in (tmp_path / "jax").rglob("*"))
    table = back.to_table(64, device="cpu")
    assert table.has_cluster.tolist() == [True, False, True]


def test_dest_color_chunked_matches_jax(rng):
    k = 6
    centers = rng.uniform(0.15, 0.9, size=(k, 3)).astype(np.float32)
    per_class = []
    for c in range(3):
        links = rng.integers(0, k, 300)
        anchors = ta.map_drgb(centers[links]) + rng.normal(size=(300, 3)).astype(np.float32) * 0.01
        per_class.append(None if c == 1 else (anchors, links, centers))
    tt = ta.table_from_numpy(per_class, 512, device="cpu")
    tj = ja.table_from_numpy(per_class, 512)
    n = 20_000  # not a multiple of the chunk
    rgb = np.clip(centers[rng.integers(0, k, n)] + rng.normal(size=(n, 3)) * 0.03, 0.05, 1)
    rgb = rgb.astype(np.float32)
    lab = rng.integers(0, 3, n)
    got = ta.dest_color_chunked(tt, torch.from_numpy(rgb), torch.from_numpy(lab), chunk=8192)
    ref = ja.dest_color_chunked(tj, jnp.asarray(rgb), jnp.asarray(lab), chunk=8192)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[lab == 1], rgb[lab == 1])  # no clusters: input
    assert torch.equal(got, ta.dest_color(tt, torch.from_numpy(rgb), torch.from_numpy(lab)))


def test_native_builds_into_the_port_not_the_jax_tree():
    path = tnative.library_path()
    assert path.startswith(tnative.BUILD_DIR)
    assert "native/libintrinsic_native.so" not in path
    assert tnative.SOURCE.endswith("native/intrinsic_native.cpp")
