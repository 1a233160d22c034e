"""The numbers that decide ``correct``, each a gap between what the timed
path produced and the reference.

Training (``train_numbers``): the relative gap of each observed step's
total loss; and, by the worst leaf, the gap between the program's norm
and the reference's of the first observed gradient and of the
parameters' change over the observed steps, against the reference's
norm of that leaf or of the median leaf, whichever is larger.  Leaves
whose reference gradient is under a thousandth of the median leaf's
are left out of the change: Adam moves them by round-off alone.

The cluster table (``table_gap``): over the pixels of the reference's
own rebuild, with the reference's classes, the mean of each pixel's
error: 1 where its class has clusters in one table and not in the
other, 0 where in neither, else the gap between the colours of its
nearest anchor in the two tables over the reference's colour.

The pose sampler past its warm-up (``sampler_gap``): the share of the
drawn pairs whose colour or mask differs from the reference's draw;
an exact comparison.

Rendering (``render_numbers``): for each map ``render_views`` yields
(the disparity as its reciprocal, the clamped depth over opacity, which
stays finite on empty rays), each pixel's error over the map's RMS in
its view; the worst pixel of any checked view and map counts
(``QUANTILE`` 1: a fault on a single pixel of one view shows).  The semantic logits are compared through their
entropy map; their argmax label is not compared (at the seeded weights
the float8 control flips no label on some seeds, so a label gap has no
reading to set a limit under).
"""

from __future__ import annotations

from statistics import median
from typing import Dict

import torch

from perfbench.reference import cluster

QUANTILE = 1.0
MAPS = ("rgb", "depth", "disp", "acc", "albedo", "shading", "residual", "sem_entropy")


def _norms(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, float]:
    return {f"{lvl}/{k}": float(v.double().norm()) for lvl, leaves in tree.items()
            for k, v in leaves.items()}


def worst_leaf_gap(prog, ref, leaves=None) -> float:
    """max over leaves of ``| |prog| - |ref| | / max(|ref|, median |ref|)``."""
    np_, nr = _norms(prog), _norms(ref)
    keys = list(nr) if leaves is None else list(leaves)
    med = median(nr[k] for k in keys)
    return max(abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keys)


def moving_leaves(ref_grads) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = _norms(ref_grads)
    med = median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def delta(after, before):
    return {lvl: {k: after[lvl][k].float() - before[lvl][k].float() for k in before[lvl]}
            for lvl in before}


def train_numbers(prog_losses: Dict[int, float], ref_losses: Dict[int, float], prog_grads,
                  ref_grads, prog_change, ref_change) -> Dict[str, float]:
    loss = max(abs(prog_losses[s] - ref_losses[s]) / max(abs(ref_losses[s]), 1e-30)
               for s in ref_losses)
    return {"loss": loss, "grad": worst_leaf_gap(prog_grads, ref_grads),
            "change": worst_leaf_gap(prog_change, ref_change, moving_leaves(ref_grads))}


def table_gap(prog: dict, ref: dict, albedo: torch.Tensor, label: torch.Tensor) -> float:
    """The table number of the program's table ``prog`` against the
    reference's ``ref``, over the reference's rebuild pixels."""
    cp, hp = cluster.lookup(prog, albedo, label)
    cr, hr = cluster.lookup(ref, albedo, label)
    gap = (cp - cr).double().norm(dim=-1) / cr.double().norm(dim=-1).clamp(min=1e-30)
    err = torch.where(hp != hr, torch.ones_like(gap), torch.where(hr, gap, torch.zeros_like(gap)))
    return float(err.mean())


def sampler_gap(prog, ref) -> float:
    """``prog``, ``ref``: (colours [2N, 3], masks [2N]) of one draw; a
    draw of another size differs everywhere."""
    if prog[0].shape != ref[0].shape or prog[1].shape != ref[1].shape:
        return 1.0
    differs = (prog[0] != ref[0]).any(-1) | (prog[1] != ref[1])
    return float(differs.double().mean())


def render_errors(pairs) -> Dict[str, list]:
    """``pairs``: (program view {map: array}, reference view {map:
    tensor}) for each checked view.  Each map's per-pixel errors, one
    tensor a view."""
    errors = {m: [] for m in MAPS}
    for prog, ref in pairs:
        n = ref["acc"].numel()
        for m in MAPS:
            if m not in prog:
                continue
            p = torch.as_tensor(prog[m]).to(ref[m].device).double().reshape(n, -1)
            r = ref[m].double().reshape(n, -1)
            if m == "disp":
                p, r = 1.0 / p, 1.0 / r
            scale = r.pow(2).mean().sqrt().clamp(min=1e-30)
            errors[m].append(((p - r).abs().amax(-1) / scale).float())
    return {m: e for m, e in errors.items() if e}


def worst_view(errors: Dict[str, list], q: float) -> float:
    return max(float(torch.quantile(e, q)) for views in errors.values() for e in views)


def render_numbers(pairs) -> Dict[str, float]:
    return {"maps": worst_view(render_errors(pairs), QUANTILE)}
