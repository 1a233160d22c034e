"""The work of the network, counted from the published architecture and
the points a call evaluates, never from the program's kernels.

- Forward: 2 FLOP per multiply-add of the network's own layers (trunk,
  skip, heads, view branch) at the configuration's class count.
- Backward: the weight gradients (one multiply-add per weight per point)
  and the activation gradients the chain rule needs; there is no
  gradient into the encoded inputs (the first layer's, the skip's
  encoded half and the view branch's encoded direction), and nothing is
  recomputed.
- Bytes: each logical input read once and each logical output written
  once, in float32: per point its position, per ray its direction, the
  float32 weights; out, per point the density, albedo, shading, residual
  and class logits (``8 + C`` values), and in the backward their
  gradients in and the weight gradients out.
- A roofline time is the larger of operations over the peak rate and
  bytes over the peak bandwidth.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def layers(arch: dict) -> Dict[str, tuple]:
    """``{layer: (fan_in, fan_out, encoded inputs among fan_in)}``."""
    w, c = arch["width"], arch["classes"]
    in_pts = 3 * (1 + 2 * arch["n_freqs_pos"])
    in_dir = 3 * (1 + 2 * arch["n_freqs_dir"])
    out = {}
    fan_in, enc = in_pts, in_pts
    for i in range(arch["depth"]):
        out[f"pts_linears.{i}"] = (fan_in, w, enc)
        fan_in, enc = (w + in_pts, in_pts) if i in arch["skips"] else (w, 0)
    out.update({"alpha_linear": (w, 1, 0), "albedo_linear1": (w, w // 2, 0),
                "albedo_linear2": (w // 2, 3, 0), "shading_linear1": (w, w // 2, 0),
                "shading_linear2": (w // 2, 1, 0), "feature_linear": (w, w, 0),
                "views_linears.0": (w + in_dir, w // 2, in_dir),
                "residual_linear": (w // 2, 3, 0)})
    if c > 0:
        out.update({"semantic_linear.0.0": (w, w // 2, 0), "semantic_linear.1": (w // 2, c, 0)})
    return out


def macs_per_point(arch: dict) -> int:
    return sum(i * o for i, o, _ in layers(arch).values())


def act_grad_macs_per_point(arch: dict) -> int:
    """Multiply-adds of the activation gradients: every layer's input
    gradient but its encoded part's."""
    return sum((i - e) * o for i, o, e in layers(arch).values())


def params(arch: dict) -> int:
    return sum(i * o + o for i, o, _ in layers(arch).values())


def points_per_ray(arch: dict) -> int:
    """Coarse samples, plus the coarse and importance samples the fine
    network evaluates."""
    nc, ni = arch["n_coarse"], arch["n_importance"]
    return nc + (nc + ni if ni > 0 else 0)


def levels(arch: dict) -> int:
    return 2 if arch["n_importance"] > 0 else 1


def forward(arch: dict, rays: int) -> tuple:
    """(FLOP, bytes) of both levels' forward over ``rays`` rays."""
    pts = rays * points_per_ray(arch)
    outs = 8 + arch["classes"]
    flop = 2 * macs_per_point(arch) * pts
    nbytes = 4 * (3 * pts + 3 * rays * levels(arch) + params(arch) * levels(arch) + outs * pts)
    return flop, nbytes


def backward(arch: dict, rays: int) -> tuple:
    """(FLOP, bytes) of both levels' backward over ``rays`` rays."""
    pts = rays * points_per_ray(arch)
    outs = 8 + arch["classes"]
    flop = 2 * (macs_per_point(arch) + act_grad_macs_per_point(arch)) * pts
    nbytes = 4 * (3 * pts + 3 * rays * levels(arch) + 2 * params(arch) * levels(arch)
                  + outs * pts)
    return flop, nbytes


def roofline_s(flop: float, nbytes: float) -> float:
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
