"""The plain reference of one IntrinsicNeRF training step.

From the published description, in plain PyTorch at float32; it imports
nothing of the program.  A step draws its pixels and its render noise
from a ``torch.Generator`` in a fixed order (the image, the pixels, the
neighbour offsets; then the stratified jitter, the coarse density noise,
the sorted importance uniforms and the fine density noise, each only
where the configuration asks for it), so one seed gives both sides the
same draws.  Then:

- pixel pairs: each drawn pixel and a neighbour at an offset in
  {-1, 0, 1}^2 clamped to the frame, the pixels first; the scene reads
  its rays from the per-image ray pool, the object builds them from the
  image's pose (its pixels in the centre crop while the step count is
  below ``precrop_iters``);
- the render of ``nerf.render`` with the draws, on both levels;
- per level: the photometric MSE, the semantic cross-entropy over
  non-void labels (label - 1), the chromaticity loss, the residual
  energy, the reflectance sparsity and shading smoothness of the pixel
  pairs weighted by ``exp(-60 d2)`` of their ground-truth chromaticity
  gap ``d2`` (gated by equal labels, or by the object mask product), the
  same sparsity over far pairs (the first and the last quarter of the
  pixels), the intensity term, and the reflectance-cluster MSE of the
  albedo against its nearest anchor's centre colour (the class is the
  fine level's argmax label), all with the configuration's weights;
- Adam (0.9, 0.999, 1e-8) at ``lrate * 0.1^(step / lrate_decay)``
  read at the step count before the update.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import cluster, nerf


def draw_pixels(gen: torch.Generator, hp: dict, n_img: int, step: int, device):
    """(image [], rows [N], cols [N], neighbour offsets [N], [N])."""
    h, w, n = hp["h"], hp["w"], hp["n_rays"]

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device)

    img = randint(0, n_img, ())
    if hp["sampler"] == "pool":
        idx = randint(0, h * w, (n,))
        rows, cols = idx // w, idx % w
    elif hp.get("precrop_iters", 0) > 0:
        crops = []
        for frac in (hp["precrop_frac"], 1.0):
            dh = max(int(torch.tensor(h // 2, dtype=torch.float32) * frac), 1)
            dw = max(int(torch.tensor(w // 2, dtype=torch.float32) * frac), 1)
            crops.append((h // 2 - dh + randint(0, 2 * dh, (n,)),
                          w // 2 - dw + randint(0, 2 * dw, (n,))))
        crop = 0 if step < hp["precrop_iters"] else 1
        rows, cols = crops[crop]
    else:
        rows, cols = randint(0, h, (n,)), randint(0, w, (n,))
    return img, rows, cols, randint(-1, 2, (n,)), randint(-1, 2, (n,))


def draw_render(gen: torch.Generator, arch: dict, n: int, device) -> dict:
    nc, ni = arch["n_coarse"], arch["n_importance"]
    jitter, noisy = arch["perturb"] > 0, arch["raw_noise_std"] > 0
    out = {"t": None, "noise_c": None, "u": None, "noise_f": None}
    if jitter:
        out["t"] = torch.rand(n, nc, generator=gen, device=device)
    if noisy:
        out["noise_c"] = torch.randn(n, nc, generator=gen, device=device) * arch["raw_noise_std"]
    if ni > 0 and jitter:
        e = -torch.log1p(-torch.rand(n, ni + 1, generator=gen, device=device))
        c = torch.cumsum(e, -1)
        out["u"] = c[:, :-1] / c[:, -1:]
    if ni > 0 and noisy:
        out["noise_f"] = (torch.randn(n, nc + ni, generator=gen, device=device)
                          * arch["raw_noise_std"])
    return out


def batch(data: dict, hp: dict, img, rows, cols, bh, bw) -> dict:
    """The paired rays and their ground truth."""
    h, w = hp["h"], hp["w"]
    nr = (rows + bh).clamp(0, h - 1)
    nc = (cols + bw).clamp(0, w - 1)
    idx = torch.cat([rows * w + cols, nr * w + nc])
    if hp["sampler"] == "pool":
        return {"rays": data["rays"][img, idx], "rgb": data["rgb"][img, idx],
                "label": data["semantic"][img, idx],
                "sem_flag": data["mask_ids"][img].float()}
    c2w = data["poses"][img]
    d = data["dirs_cam"][idx] @ c2w[:3, :3].T
    o = c2w[:3, 3].expand(d.shape)
    nf = torch.tensor([hp["near"], hp["far"]], device=d.device).expand(d.shape[0], 2)
    rays = torch.cat([o, d, nf, d / d.norm(dim=-1, keepdim=True)], -1)
    return {"rays": rays, "rgb": data["rgb"][img, idx], "label": data["mask"][img, idx],
            "sem_flag": torch.zeros((), device=d.device)}


def chroma(c):
    s = c.sum(-1) + 1e-5
    return c[..., 0] / s, c[..., 1] / s


def pair_weights(c1, c2, l1, l2, mode):
    r1, g1 = chroma(c1)
    r2, g2 = chroma(c2)
    d2 = (r1 - r2) ** 2 + (g1 - g2) ** 2
    if mode == "label":
        return torch.exp(-60.0 * d2) * (l1 == l2).float(), d2
    m = l1 * l2
    return torch.exp(-60.0 * d2) * m, d2 * m


def nearest_colour(table: dict, rgb, label):
    """Each colour's nearest anchor of its class in ``[I/3 * f, g/I, b/I]``
    space (``I = r + g + b``), as that anchor's centre colour; the input
    colour where the class has no cluster."""
    out, has = cluster.lookup(table, rgb, label)
    return torch.where(has[:, None], out, rgb)


def level_loss(maps, b, hp, w_res, w_i, target, w_c) -> Dict[str, torch.Tensor]:
    n = maps["rgb"].shape[0] // 2
    gt = b["rgb"]
    terms = {"img": ((maps["rgb"] - gt) ** 2).mean()}
    zero = terms["img"].new_zeros(())
    if "sem" in maps:
        tgt = b["label"].long() - 1
        valid = tgt >= 0
        nll = -torch.log_softmax(maps["sem"], -1).gather(-1, tgt.clamp(min=0)[:, None])[:, 0]
        terms["sem"] = (nll * valid).sum() / valid.sum().clamp(min=1) * b["sem_flag"]
    else:
        terms["sem"] = zero
    a, s = maps["albedo"], maps["shading"]
    label = b["label"] if hp["pair_mode"] == "label" else b["label"].float()
    ra, ga = chroma(a)
    rg, gg = chroma(gt)
    terms["chroma"] = ((ra - rg) ** 2).mean() + ((ga - gg) ** 2).mean()
    terms["residual"] = (maps["residual"] ** 2).mean()
    w, inv_w = pair_weights(gt[:n], gt[n:], label[:n], label[n:], hp["pair_mode"])
    terms["sparsity"] = (w * ((a[:n] - a[n:]) ** 2).sum(-1)).mean()
    terms["smooth"] = (inv_w * (s[:n] - s[n:]) ** 2).mean()
    m = n // 2
    w_far, _ = pair_weights(gt[:m], gt[n - m:n], label[:m], label[n - m:n], hp["pair_mode"])
    terms["far"] = (w_far * ((a[:m] - a[n - m:n]) ** 2).sum(-1)).mean()
    terms["intensity"] = (gt.mean() - a.mean()) ** 2
    terms["cluster"] = ((a - target) ** 2).mean() if target is not None else zero
    if hp["no_intrinsic_loss"]:
        total = terms["img"] + hp["wgt_sem"] * terms["sem"]
    else:
        total = (terms["img"] + hp["wgt_sem"] * terms["sem"] + hp["w_chroma"] * terms["chroma"]
                 + w_res * terms["residual"] + hp["w_n"] * terms["sparsity"]
                 + hp["w_s"] * terms["smooth"] + hp["w_f"] * terms["far"]
                 + w_i * terms["intensity"])
    terms["total"] = total + w_c * terms["cluster"]
    return terms


class Adam:
    """Adam over a dict of leaves, ``lrate * 0.1^(step / lrate_decay)``."""

    def __init__(self, params: Dict[str, torch.Tensor], hp: dict):
        self.hp = hp
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, params, grads, step: int):
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr = self.hp["lrate"] * 0.1 ** (step / self.hp["lrate_decay"])
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


def step(params: Dict[str, Dict[str, torch.Tensor]], opt: Adam, data: dict, gen, arch: dict,
         hp: dict, table: Optional[dict], w_c: float, step_count: int,
         precision: str = "float32", fault: Optional[str] = None):
    """One training step on ``params`` (``{"coarse": leaves, "fine":
    leaves}``, updated in place).  Returns (terms of the total, gradients
    by level).  ``fault`` plants one of the faults the comparison has to
    catch: ``"half_batch"`` trains on half of the pairs (the mean taken
    over them), ``"unchanged"`` leaves the parameters as they were."""
    device = data["rgb"].device
    n_img = data["rgb"].shape[0]
    picks = draw_pixels(gen, hp, n_img, step_count, device)
    b = batch(data, hp, *picks)
    draws = draw_render(gen, arch, b["rays"].shape[0], device)
    if fault == "half_batch":
        n = hp["n_rays"]
        keep = torch.cat([torch.arange(0, n // 2), torch.arange(n, n + n // 2)]).to(device)
        b = {k: (v[keep] if v.dim() else v) for k, v in b.items()}
        draws = {k: (v[keep] if v is not None else None) for k, v in draws.items()}
    leaves = {lvl: {k: v.detach().requires_grad_(True) for k, v in p.items()}
              for lvl, p in params.items()}
    coarse, fine = nerf.render(leaves["coarse"], leaves.get("fine"), arch, b["rays"], draws,
                               precision)
    last = fine if fine is not None else coarse
    target = None
    if table is not None:
        with torch.no_grad():
            cls = (last["sem"].argmax(-1) if "sem" in last
                   else torch.zeros(last["albedo"].shape[0], dtype=torch.long, device=device))
            target = nearest_colour(table, last["albedo"].detach(), cls)
    w_res = hp["w_res1"] if step_count <= hp["residual_switch"] else hp["w_res2"]
    w_i = hp["w_i1"] if step_count <= hp["intensity_switch"] else hp["w_i2"]
    terms = [level_loss(m, b, hp, w_res, w_i, target, w_c) for m in (coarse, fine) if m is not None]
    total = sum(t["total"] for t in terms)
    names = list(leaves)
    flat = [v for lvl in names for v in leaves[lvl].values()]
    gflat = torch.autograd.grad(total, flat, allow_unused=True)
    grads, i = {}, 0
    for lvl in names:
        grads[lvl] = {}
        for k, v in leaves[lvl].items():
            g = gflat[i]
            grads[lvl][k] = torch.zeros_like(v) if g is None else g.detach()
            i += 1
    if fault != "unchanged":
        opt.update({f"{lvl}/{k}": params[lvl][k] for lvl in names for k in params[lvl]},
                   {f"{lvl}/{k}": grads[lvl][k] for lvl in names for k in grads[lvl]},
                   step_count)
    return {"total": total.detach()}, grads


def follow(init: Dict[str, Dict[str, torch.Tensor]], data: dict, seed: int, n_steps: int,
           arch: dict, hp: dict, table: Optional[dict], w_c: float,
           observe=(), precision: str = "float32", fault: Optional[str] = None):
    """``n_steps`` reference steps from ``init`` with the draws of
    ``seed``.  Returns the total loss after each step numbered in
    ``observe`` (1-based), the gradients of the first step in it, and the
    parameters after the last."""
    device = data["rgb"].device
    params = {lvl: {k: v.detach().clone().float() for k, v in p.items()}
              for lvl, p in init.items()}
    opt = Adam({f"{lvl}/{k}": v for lvl in params for k, v in params[lvl].items()}, hp)
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, first_grads = {}, None
    for s in range(n_steps):
        terms, grads = step(params, opt, data, gen, arch, hp, table, w_c, s, precision, fault)
        if s + 1 in observe:
            losses[s + 1] = float(terms["total"])
            if first_grads is None:
                first_grads = grads
    return losses, first_grads, params
