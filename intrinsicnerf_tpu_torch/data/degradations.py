"""The label-degradation experiments of the scene pipeline.

The port's numpy copy of ``intrinsicnerf_tpu/data/degradations.py``,
making the same ``np.random.RandomState(seed)`` calls in the same order,
so its labels and ``mask_ids`` equal the JAX package's exactly:

- ``sample_label_maps``: semantic supervision on a sparse subset of the
  training frames (evenly spaced or random), ``mask_ids`` 0 elsewhere;
- ``add_pixel_wise_noise_label``: a share of the labelled pixels of the
  supervised frames flipped to another class;
- ``add_instance_wise_noise_label``: whole instances flipped;
- ``super_resolve_label``: labels downsampled by nearest and blown up
  again;
- ``simulate_user_click_partial``: one region-grown click per class and
  frame kept, the rest void.

Each works in place on a loaded dataset's remapped training labels and
``mask_ids``, on the host, once, before the pools go to the device.
"""

from __future__ import annotations

import numpy as np


def sample_label_maps(
    dataset, sparse_ratio: float = 0.5, random_sample: bool = False, seed: int = 0
):
    """Disable semantic supervision on a ``sparse_ratio`` fraction of
    training frames (evenly spaced, or random when ``random_sample``)."""
    n = dataset.train_num
    keep = max(1, int(round(n * (1.0 - sparse_ratio))))
    if random_sample:
        ids = np.random.RandomState(seed).permutation(n)[:keep]
    else:
        step = max(1, n // keep)
        ids = np.arange(0, n, step)[:keep]
    mask = np.zeros(n, np.int64)
    mask[ids] = 1
    dataset.mask_ids = mask
    return ids


def add_pixel_wise_noise_label(
    dataset, noise_ratio: float = 0.3, seed: int = 0
):
    """Flip ``noise_ratio`` of non-void labeled pixels (on supervised
    frames) to a uniformly random *other* valid class."""
    rng = np.random.RandomState(seed)
    sem = dataset.train_samples["semantic_remap"]
    num_class = dataset.num_semantic_class  # incl. void at 0
    for i in range(dataset.train_num):
        if dataset.mask_ids[i] == 0:
            continue
        labels = sem[i]
        valid = np.flatnonzero(labels.reshape(-1) > 0)
        n_noise = int(len(valid) * noise_ratio)
        if n_noise == 0:
            continue
        pick = rng.choice(valid, n_noise, replace=False)
        flat = labels.reshape(-1)
        old = flat[pick]
        # random other class in [1, num_class)
        new = rng.randint(1, num_class, size=n_noise)
        bump = new >= old
        # shift to skip the original label so the flip always changes it
        new = np.where(bump & (new + 1 < num_class), new + 1, new)
        new = np.where(new == old, (old % (num_class - 1)) + 1, new)
        flat[pick] = new
    return dataset


def add_instance_wise_noise_label(
    dataset,
    instance_maps: np.ndarray,  # [N, H, W] instance ids
    flip_ratio: float = 0.3,
    seed: int = 0,
):
    """Flip whole instances to a random other class (SSR's
    chair-flip experiment generalized)."""
    rng = np.random.RandomState(seed)
    sem = dataset.train_samples["semantic_remap"]
    num_class = dataset.num_semantic_class
    for i in range(dataset.train_num):
        if dataset.mask_ids[i] == 0:
            continue
        inst = instance_maps[i]
        ids = np.unique(inst)
        flip = ids[rng.rand(len(ids)) < flip_ratio]
        for iid in flip:
            region = inst == iid
            cur = sem[i][region]
            if len(cur) == 0 or cur.max() == 0:
                continue
            new = rng.randint(1, num_class)
            sem[i][region] = new
    return dataset


def super_resolve_label(dataset, down_scale_factor: int = 8):
    """Replace training labels with nearest-downsampled-then-upsampled
    low-res labels (GT kept in semantic_remap_clean for eval)."""
    sem = dataset.train_samples["semantic_remap"]
    f = down_scale_factor
    low = sem[:, ::f, ::f]
    up = np.repeat(np.repeat(low, f, axis=1), f, axis=2)
    dataset.train_samples["semantic_remap"] = up[
        :, : sem.shape[1], : sem.shape[2]
    ].copy()
    return dataset


def _region_grow(labels: np.ndarray, r0: int, c0: int, max_pixels: int):
    """BFS flood fill of the clicked pixel's class, capped at
    ``max_pixels`` (SSR's simulated click region)."""
    from collections import deque

    h, w = labels.shape
    target = labels[r0, c0]
    seen = np.zeros_like(labels, bool)
    out = np.zeros_like(labels, bool)
    q = deque([(r0, c0)])
    seen[r0, c0] = True
    count = 0
    while q and count < max_pixels:
        r, c = q.popleft()
        if labels[r, c] != target:
            continue
        out[r, c] = True
        count += 1
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rr, cc = r + dr, c + dc
            if 0 <= rr < h and 0 <= cc < w and not seen[rr, cc]:
                seen[rr, cc] = True
                q.append((rr, cc))
    return out


def simulate_user_click_partial(dataset, perc: float = 0.01, seed: int = 0):
    """Keep only one region-grown click per present class per frame
    (~``perc`` of the frame each); all other pixels become void (0)."""
    rng = np.random.RandomState(seed)
    sem = dataset.train_samples["semantic_remap"]
    h, w = sem.shape[1:3]
    budget = max(1, int(h * w * perc))
    for i in range(dataset.train_num):
        if dataset.mask_ids[i] == 0:
            continue
        labels = sem[i]
        keep = np.zeros_like(labels, bool)
        for cls in np.unique(labels):
            if cls == 0:
                continue
            rs, cs = np.nonzero(labels == cls)
            j = rng.randint(len(rs))
            keep |= _region_grow(labels, rs[j], cs[j], budget)
        sem[i] = np.where(keep, labels, 0)
    return dataset
