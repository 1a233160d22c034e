"""The plain reference of the intrinsic NeRF: network, sampling, compositing.

Written from the published description (NeRF with the Semantic-NeRF
semantic head and the IntrinsicNeRF albedo / shading / residual heads),
in plain PyTorch at float32, with no kernel, cache or batching of the
program under test.  It imports nothing of the program.

- positional encoding ``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(F-1) x),
  cos(2^(F-1) x)]`` of the position divided by ``pos_scale`` and of the
  unit view direction;
- trunk of ``depth`` ReLU layers of ``width``, the encoded position
  concatenated in front of the feature after each layer in ``skips``;
- heads off the trunk feature: density (linear), semantic logits
  (W -> W/2 -> C), albedo (W -> W/2 -> 3, sigmoid), shading
  (W -> W/2 -> 1, sigmoid); a linear feature concatenated with the
  encoded direction -> W/2, ReLU -> residual (3, sigmoid);
  ``rgb = albedo * shading + residual``;
- ``alpha = 1 - exp(-relu(sigma + noise) * dist)`` with the last
  distance 1e10 and distances scaled by ``|ray_d|``, weights
  ``alpha * prod_{j<i}(1 - alpha_j + 1e-10)``, the white background
  added to rgb, albedo, shading and the semantic logits;
- 64 stratified samples, 128 more drawn from the coarse weights of the
  interior bins (``+1e-5``) by the inverse CDF, evaluated with the coarse
  ones by the fine network.

``precision`` puts every linear layer's operands (and in a backward pass
its output gradient) through ``float32`` (the reference), ``bfloat16`` or
``float8`` (e4m3 operands and e5m2 gradients, each tensor scaled to its
format's largest finite value), with float32 sums: the lower ones serve
as the control of the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

PRECISIONS = ("float32", "bfloat16", "float8")


def quantize(x: torch.Tensor, precision: str, grad: bool = False) -> torch.Tensor:
    """``x`` rounded to ``precision`` and back to float32."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "float8":
        dtype = torch.float8_e5m2 if grad else torch.float8_e4m3fn
        top = torch.finfo(dtype).max
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = top / amax
        return (x * scale).to(dtype).float() / scale
    raise ValueError(f"unknown precision {precision!r}")


class _Linear(torch.autograd.Function):
    """``x @ w.T + b`` with rounded operands and float32 sums."""

    @staticmethod
    def forward(ctx, x, w, b, precision):
        xq, wq = quantize(x, precision), quantize(w, precision)
        ctx.save_for_backward(xq, wq)
        ctx.precision = precision
        return xq @ wq.T + b

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = quantize(gy, ctx.precision, grad=True)
        gx = gq @ wq
        g2 = gq.reshape(-1, gq.shape[-1])
        gw = g2.T @ xq.reshape(-1, xq.shape[-1])
        gb = gy.reshape(-1, gy.shape[-1]).sum(0)
        return gx, gw, gb, None


def linear(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           precision: str) -> torch.Tensor:
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    if precision == "float32":
        return torch.nn.functional.linear(x, w, b)
    return _Linear.apply(x, w, b, precision)


def encode(x: torch.Tensor, n_freqs: int, scale: float = 1.0) -> torch.Tensor:
    x = x / scale
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin(x * 2.0**k), torch.cos(x * 2.0**k)]
    return torch.cat(parts, -1)


def layer_shapes(arch: dict) -> Dict[str, tuple]:
    """``{leaf name: shape}`` of one level's parameters, under the
    published state_dict's names (``[out, in]`` weights)."""
    w, d, c = arch["width"], arch["depth"], arch["classes"]
    in_pts = 3 * (1 + 2 * arch["n_freqs_pos"])
    in_dir = 3 * (1 + 2 * arch["n_freqs_dir"])
    lin = {}
    fan_in = in_pts
    for i in range(d):
        lin[f"pts_linears.{i}"] = (w, fan_in)
        fan_in = w + in_pts if i in arch["skips"] else w
    lin.update({"alpha_linear": (1, w), "albedo_linear1": (w // 2, w),
                "albedo_linear2": (3, w // 2), "shading_linear1": (w // 2, w),
                "shading_linear2": (1, w // 2), "feature_linear": (w, w),
                "views_linears.0": (w // 2, w + in_dir), "residual_linear": (3, w // 2)})
    if c > 0:
        lin["semantic_linear.0.0"] = (w // 2, w)
        lin["semantic_linear.1"] = (c, w // 2)
    shapes = {}
    for name, (o, i) in lin.items():
        shapes[f"{name}.weight"] = (o, i)
        shapes[f"{name}.bias"] = (o,)
    return shapes


def network(params, arch: dict, pts: torch.Tensor, viewdirs: torch.Tensor,
            precision: str = "float32") -> Dict[str, torch.Tensor]:
    """Raw outputs at ``pts [..., S, 3]`` seen along ``viewdirs [..., 3]``."""
    x = encode(pts, arch["n_freqs_pos"], arch["pos_scale"])
    d = encode(viewdirs, arch["n_freqs_dir"])[..., None, :].expand(*pts.shape[:-1], -1)
    h = x
    for i in range(arch["depth"]):
        h = torch.relu(linear(params, f"pts_linears.{i}", h, precision))
        if i in arch["skips"]:
            h = torch.cat([x, h], -1)

    def head(a, b, act):
        return act(linear(params, b, torch.relu(linear(params, a, h, precision)), precision))

    out = {
        "sigma": linear(params, "alpha_linear", h, precision)[..., 0],
        "albedo": head("albedo_linear1", "albedo_linear2", torch.sigmoid),
        "shading": head("shading_linear1", "shading_linear2", torch.sigmoid)[..., 0],
    }
    if arch["classes"] > 0:
        out["sem"] = head("semantic_linear.0.0", "semantic_linear.1", lambda t: t)
    feat = linear(params, "feature_linear", h, precision)
    hv = torch.relu(linear(params, "views_linears.0", torch.cat([feat, d], -1), precision))
    out["residual"] = torch.sigmoid(linear(params, "residual_linear", hv, precision))
    out["rgb"] = out["albedo"] * out["shading"][..., None] + out["residual"]
    return out


def composite(raw, z, rays_d, noise: Optional[torch.Tensor], white_bkgd: bool):
    dist = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], -1)
    dist = dist * rays_d.norm(dim=-1, keepdim=True)
    sigma = raw["sigma"] if noise is None else raw["sigma"] + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dist)
    keep = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]], -1)
    wts = alpha * trans
    maps = {"weights": wts, "acc": wts.sum(-1), "depth": (wts * z).sum(-1),
            "shading": (wts * raw["shading"]).sum(-1)}
    for k in ("rgb", "albedo", "residual", "sem"):
        if k in raw:
            maps[k] = (wts[..., None] * raw[k]).sum(-2)
    acc = maps["acc"]
    ratio = maps["depth"] / torch.where(acc > 0, acc, torch.ones_like(acc))
    maps["disp"] = 1.0 / torch.clamp(ratio, min=1e-10)
    if white_bkgd:
        rest = 1.0 - acc
        for k in ("rgb", "albedo", "sem"):
            if k in maps:
                maps[k] = maps[k] + rest[..., None]
        maps["shading"] = maps["shading"] + rest
    return maps


def inverse_cdf(bins, weights, u):
    """Depths drawn at the uniforms ``u [N, M]`` (sorted) from the
    piecewise-constant density of ``weights [N, B-1]`` over ``bins [N, B]``."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    lo = (idx - 1).clamp(min=0)
    hi = idx.clamp(max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    span = c_hi - c_lo
    span = torch.where(span < 1e-5, torch.ones_like(span), span)
    return b_lo + (u - c_lo) / span * (b_hi - b_lo)


def render(params_c, params_f, arch: dict, rays: torch.Tensor, draws: Optional[dict] = None,
           precision: str = "float32"):
    """(coarse maps, fine maps) of ``rays [N, 11]`` (origin, direction,
    near, far, unit view direction).  ``draws`` (training) holds the
    stratified jitter ``t`` [N, Sc], the density noise ``noise_c`` /
    ``noise_f`` (already scaled, or None) and the sorted uniforms ``u``
    [N, Si]; without it the samples are evenly spaced and the uniforms
    ``linspace(0, 1)``."""
    o, d, near, far, vd = rays[:, 0:3], rays[:, 3:6], rays[:, 6:7], rays[:, 7:8], rays[:, 8:11]
    nc, ni = arch["n_coarse"], arch["n_importance"]
    t = torch.linspace(0.0, 1.0, nc, device=rays.device)
    z = near * (1.0 - t) + far * t
    if draws is not None and draws.get("t") is not None:
        mid = 0.5 * (z[:, 1:] + z[:, :-1])
        lower = torch.cat([z[:, :1], mid], -1)
        upper = torch.cat([mid, z[:, -1:]], -1)
        z = lower + (upper - lower) * draws["t"]
    noise_c = draws.get("noise_c") if draws is not None else None
    noise_f = draws.get("noise_f") if draws is not None else None
    raw = network(params_c, arch, o[:, None] + d[:, None] * z[..., None], vd, precision)
    coarse = composite(raw, z, d, noise_c, arch["white_bkgd"])
    if ni <= 0:
        return coarse, None
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    if draws is not None and draws.get("u") is not None:
        u = draws["u"]
    else:
        u = torch.linspace(0.0, 1.0, ni, device=rays.device).expand(rays.shape[0], ni)
    zi = inverse_cdf(mid, coarse["weights"][:, 1:-1].detach(), u).detach()
    z2 = torch.sort(torch.cat([z, zi], -1), -1).values
    raw = network(params_f, arch, o[:, None] + d[:, None] * z2[..., None], vd, precision)
    return coarse, composite(raw, z2, d, noise_f, arch["white_bkgd"])


def entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -(logp.exp() * logp).sum(-1)


def init_bounds(shapes: Dict[str, tuple]) -> Dict[str, float]:
    """The published initialisation ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
    of each leaf (the fan-in of its layer)."""
    out = {}
    for name, shape in shapes.items():
        layer = name.rsplit(".", 1)[0]
        out[name] = 1.0 / math.sqrt(shapes[f"{layer}.weight"][1])
    return out


@torch.no_grad()
def render_view(params_c, params_f, arch: dict, rays: torch.Tensor, block: int = 4096,
                precision: str = "float32") -> Dict[str, torch.Tensor]:
    """The maps of one view ``rays [H*W, 11]`` (the fine level's where
    there is one), ``block`` rays at a time: rgb, depth, disp, acc,
    albedo, shading, residual and, with semantics, the logits ``sem`` and
    their entropy ``sem_entropy``."""
    keys = ("rgb", "depth", "disp", "acc", "albedo", "shading", "residual", "sem")
    parts = {k: [] for k in keys}
    for r in torch.split(rays, block):
        coarse, fine = render(params_c, params_f, arch, r, None, precision)
        maps = fine if fine is not None else coarse
        for k in keys:
            if k in maps:
                parts[k].append(maps[k])
    out = {k: torch.cat(v) for k, v in parts.items() if v}
    if "sem" in out:
        out["sem_entropy"] = entropy(out["sem"])
    return out
