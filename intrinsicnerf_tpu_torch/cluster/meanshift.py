"""Flat-kernel mean-shift clustering with bin seeding (host-side numpy).

The port's copy of ``intrinsicnerf_tpu/cluster/meanshift.py``: the
bandwidth estimate (``estimate_bandwidth``, sklearn semantics), bin seeds,
the seed iteration and the sklearn-compatible post-processing.  The seed
iteration and the bandwidth estimate run in the first-party C++ of
``native/`` when it builds (:mod:`intrinsicnerf_tpu_torch.native`), else
in numpy; :func:`backend` says which.  The two paths give the same
clusters up to floating-point summation order, so a comparison with the
JAX package is exact only when both take the same path.  It runs on the
host at the cluster-rebuild cadence, off the training step.
"""

from __future__ import annotations

import numpy as np


def _native():
    """The native binding, or None when the toolchain cannot build it.
    Only availability is probed here: once the library loads, a fault in
    it surfaces rather than falling back."""
    from intrinsicnerf_tpu_torch import native

    return native if native.native_available() else None


def backend() -> str:
    """``"native"`` (C++/OpenMP) or ``"numpy"``: the path mean-shift takes."""
    return "native" if _native() is not None else "numpy"


def estimate_bandwidth(x: np.ndarray, quantile: float = 0.3, n_samples: int | None = 5000,
                       seed: int = 0) -> float:
    """Mean distance to the ``int(n*quantile)``-th nearest neighbour (self
    included), over a random subsample: sklearn semantics."""
    x = np.asarray(x, dtype=np.float64)
    if n_samples is not None and x.shape[0] > n_samples:
        idx = np.random.RandomState(seed).permutation(x.shape[0])[:n_samples]
        x = x[idx]
    n = x.shape[0]
    k = max(1, int(n * quantile))
    lib = _native()
    if lib is not None:
        return lib.estimate_bandwidth_kth(x, k)
    # squared distances in blocks; sqrt of the k-th order statistic only
    block = 1024
    x2 = np.sum(x**2, axis=1)
    total = 0.0
    for s in range(0, n, block):
        d2 = x2[s : s + block, None] + x2[None, :] - 2.0 * x[s : s + block] @ x.T
        np.maximum(d2, 0.0, out=d2)
        kth = np.partition(d2, k - 1, axis=1)[:, k - 1]
        total += np.sqrt(kth).sum()
    return float(total / n)


def _bin_seeds(x: np.ndarray, bin_size: float, min_bin_freq: int = 1) -> np.ndarray:
    """Seed points = centres of occupied grid bins of side ``bin_size``."""
    binned = np.round(x / bin_size)
    uniq, counts = np.unique(binned, axis=0, return_counts=True)
    seeds = uniq[counts >= min_bin_freq] * bin_size
    if len(seeds) == len(x):
        return x
    return seeds


def mean_shift(x: np.ndarray, bandwidth: float, bin_seeding: bool = True, max_iter: int = 300,
               point_block: int = 262144):
    """Cluster ``x [N, D]``; returns ``(cluster_centers [K, D] f32, labels [N])``.

    Seeds advance until each moves less than ``1e-3 * bandwidth``.  Seeds
    with no support within the bandwidth are dropped, centres within one
    bandwidth of a better-supported one are merged into it, and every
    point is labelled by its nearest surviving centre."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n == 0:
        raise ValueError("mean_shift called with no points")
    seeds = _bin_seeds(x, bandwidth) if bin_seeding else x.copy()
    bw2 = bandwidth * bandwidth
    lib = _native()
    if lib is not None:
        centers, support = lib.meanshift_iterate(x, seeds.astype(np.float64), bandwidth, max_iter)
        return _postprocess(x, centers, support, bw2, point_block)

    centers = seeds.astype(np.float64).copy()
    active = np.ones(len(centers), dtype=bool)
    stop_thresh = 1e-3 * bandwidth
    x2 = np.sum(x**2, axis=1)
    for _ in range(max_iter):
        if not active.any():
            break
        cur = centers[active]
        new = np.zeros_like(cur)
        cnt = np.zeros(len(cur), dtype=np.int64)
        for s in range(0, n, point_block):
            xb = x[s : s + point_block]
            d2 = (np.sum(cur**2, axis=1)[:, None] + x2[s : s + point_block][None, :]
                  - 2.0 * cur @ xb.T)
            within = d2 <= bw2
            new += within @ xb
            cnt += within.sum(axis=1)
        nonzero = cnt > 0
        new[nonzero] /= cnt[nonzero, None]
        new[~nonzero] = cur[~nonzero]
        shift = np.linalg.norm(new - cur, axis=1)
        centers[active] = new
        still = shift >= stop_thresh
        idx_active = np.flatnonzero(active)
        active[idx_active[~still]] = False

    support = np.zeros(len(centers), dtype=np.int64)
    for s in range(0, n, point_block):
        xb = x[s : s + point_block]
        d2 = (np.sum(centers**2, axis=1)[:, None] + x2[s : s + point_block][None, :]
              - 2.0 * centers @ xb.T)
        support += (d2 <= bw2).sum(axis=1)
    return _postprocess(x, centers, support, bw2, point_block)


def _postprocess(x, centers, support, bw2, point_block):
    """Drop unsupported seeds, merge near-duplicate centres (the higher
    support wins), label every point by its nearest surviving centre."""
    n = x.shape[0]
    keep = support > 0
    centers, support = centers[keep], support[keep]
    if len(centers) == 0:  # a tiny bandwidth: one centre at the first point
        centers = x[:1].copy()
        support = np.array([n])
    order = np.argsort(-support, kind="stable")
    centers = centers[order]
    alive = np.ones(len(centers), dtype=bool)
    for i in range(len(centers)):
        if not alive[i]:
            continue
        dup = np.sum((centers - centers[i]) ** 2, axis=1) < bw2
        dup[: i + 1] = False
        alive &= ~dup
    centers = centers[alive]
    labels = np.empty(n, dtype=np.int64)
    for s in range(0, n, point_block):
        xb = x[s : s + point_block]
        d2 = (np.sum(centers**2, axis=1)[None, :] + np.sum(xb**2, axis=1)[:, None]
              - 2.0 * xb @ centers.T)
        labels[s : s + point_block] = np.argmin(d2, axis=1)
    return centers.astype(np.float32), labels
