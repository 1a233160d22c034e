"""Attribution probe for the fused-MLP forward kernel.

Port of the Pallas probe ``tools_fwd_probe.py`` (``make_kernel``, launched
by ``run``): stripped-down variants of kernel 1's structure, timed one by
one to localise where its time goes.  Per point::

    z    = sum_{d<7} in8[:, d] * pe[d]         (fp32 multiply-adds, in that order)
    feat = full / norelu / nobias: sm*sin(z) + (1-sm)*z;  nosin: z;
           nope: in8[:, 0] * 0.01 in all 128 columns
    h    = feat; n_layers times  o = bf16(h) @ bf16(W_i)  (fp32 accumulation)
           full / nosin / nope: h = relu(o + b_i);  nobias: relu(o);  norelu: o
    out  = h[:, :128] in bf16 or fp32

with ``W_0 [128, 256]`` and ``W_i [256, 256]``.  Kernel 3
(``csrc/fwd_probe.cu``) computes it on the card as kernel 1 is built: a
producer warp streams a weight image (every 64-row K-slab of the stacked
weights, swizzled as it sits in shared memory; ``fwd_probe_image``, built
once per set of weights by ``probe_operands``) into wgmma products.
:func:`fwd_probe_plain` is its plain PyTorch version, and
:func:`probe_weight_image_plain` the image's.  The wrappers run the plain
versions for CPU tensors only; a CUDA tensor launches the kernel (counted
in ``fwd_probe.launches`` and ``fwd_probe_image.launches``) or raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from intrinsicnerf_tpu_torch import resolve_device
from intrinsicnerf_tpu_torch.ops.fused_mlp import swizzled_slabs

N_PTS = 196_608
W = 256
IN_W = 128
OUT_W = 128
PE_ROWS = 7  # the probe sums in8 columns 0..6, as the Pallas probe does
VARIANTS = ("full", "nosin", "nope", "norelu", "nobias")
# points per block on the card: 64, kernel 1's tile (the warpgroups split
# the columns); 128, each warpgroup on its own 64 rows
TILES = (64, 128)
MAX_LAYERS = 16


class ProbeOperands(NamedTuple):
    """The probe's constants: the plain version's operands (weights
    already rounded to bf16, held in fp32), the kernel's flat buffers and,
    on the card, its weight image."""

    pe: torch.Tensor  # [8, 128] f32
    sm: torch.Tensor  # [1, 128] f32, 1 where the column is a sinusoid
    ws: List[torch.Tensor]  # bf16-valued f32, [in, out]
    bs: List[torch.Tensor]  # [1, 256] f32
    wbuf: torch.Tensor  # flat bf16: W_0 then W_1.., each row-major
    bbuf: torch.Tensor  # [n_layers, 256] f32
    wimg: Optional[torch.Tensor]  # wbuf's weight image on the card; None on the CPU


def probe_weight_image_plain(wbuf: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 3's weight image: the stacked
    weights ``[128 + 256 (n_layers - 1), 256]`` (``wbuf``'s rows) as
    2 + 4 (n_layers - 1) swizzled K-slabs of 32 KB, in the order the
    kernel's products consume them."""
    return swizzled_slabs(wbuf.view(IN_W + (n_layers - 1) * W, W))


def fwd_probe_image(wbuf: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Kernel 3's weight image of the flat bf16 weights ``wbuf`` of
    ``n_layers`` layers.  CPU tensors take the plain version; CUDA tensors
    launch ``probe_wimg_kernel`` (one launch, counted in
    ``fwd_probe_image.launches``)."""
    n_elems = (IN_W + (n_layers - 1) * W) * W
    if not 1 <= n_layers <= MAX_LAYERS or wbuf.dtype != torch.bfloat16 or \
            wbuf.shape != (n_elems,):
        raise ValueError(f"the probe's weights of {n_layers} layers must be bfloat16 "
                         f"[{n_elems}], got {wbuf.dtype} {tuple(wbuf.shape)}")
    if wbuf.device.type == "cpu":
        return probe_weight_image_plain(wbuf, n_layers)
    if wbuf.device.type != "cuda":
        raise ValueError(f"fwd_probe_image: unsupported device {wbuf.device}")
    from intrinsicnerf_tpu_torch.ops.build import load_library

    lib = load_library("fwd_probe")
    wbuf = wbuf.contiguous()
    img = torch.empty_like(wbuf)
    with torch.cuda.device(wbuf.device):
        err = lib.fwd_probe_image(wbuf.data_ptr(), img.data_ptr(), n_layers,
                                  torch.cuda.current_stream(wbuf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fwd_probe_image launch failed: cudaError {err}")
    fwd_probe_image.launches += 1
    return img


fwd_probe_image.launches = 0


def probe_operands(pe, sm, ws, bs) -> ProbeOperands:
    """Round the weights to bf16 once (the Pallas ``_mm`` rounds them in
    every product, to the same values) and lay out the kernel's buffers;
    on the card also its weight image (one ``fwd_probe_image`` launch)."""
    n_layers = len(ws)
    if not 1 <= n_layers <= MAX_LAYERS or len(bs) != n_layers:
        raise ValueError(f"the probe takes 1..{MAX_LAYERS} layers, each with a bias; "
                         f"got {len(ws)} weights and {len(bs)} biases")
    shapes = [(IN_W, W)] + [(W, W)] * (n_layers - 1)
    if [tuple(w.shape) for w in ws] != shapes:
        raise ValueError(f"weights must be {shapes}, got {[tuple(w.shape) for w in ws]}")
    w16 = [w.to(torch.bfloat16) for w in ws]
    bs = [b.float().reshape(1, W) for b in bs]
    wbuf = torch.cat([w.reshape(-1) for w in w16]).contiguous()
    return ProbeOperands(
        pe=pe.float().reshape(8, IN_W).contiguous(), sm=sm.float().reshape(1, IN_W).contiguous(),
        ws=[w.float() for w in w16], bs=bs, wbuf=wbuf, bbuf=torch.cat(bs).contiguous(),
        wimg=fwd_probe_image(wbuf, n_layers) if wbuf.is_cuda else None)


def probe_inputs(n_layers: int, n: int = N_PTS, seed: int = 0, bias_scale: float = 0.0,
                 device="cuda"):
    """``(in8, ProbeOperands)`` drawn as ``tools_fwd_probe.run`` draws them
    (numpy ``default_rng(seed)``: in8, pe, sm, then the weights at 0.05
    scale).  Its biases are zero; ``bias_scale > 0`` draws them from a
    second generator instead, so that a check sees the bias path."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    in8 = rng.normal(size=(n, 8)).astype(np.float32)
    pe = rng.normal(size=(8, IN_W)).astype(np.float32)
    sm = (rng.uniform(size=(1, IN_W)) > 0.3).astype(np.float32)
    shapes = [(IN_W, W)] + [(W, W)] * (n_layers - 1)
    ws = [rng.normal(size=s).astype(np.float32) * 0.05 for s in shapes]
    brng = np.random.default_rng(seed + 1)
    bs = [(brng.normal(size=(1, W)) * bias_scale).astype(np.float32) for _ in shapes]

    def t(a):
        return torch.from_numpy(a).to(dev)

    return t(in8), probe_operands(t(pe), t(sm), [t(w) for w in ws], [t(b) for b in bs])


def probe_work(n: int, n_layers: int, out_dtype=torch.bfloat16):
    """(FLOP, bytes) of one probe call: every layer's full-width product,
    as the Pallas probe computes it; 32 bytes in and 128 outputs per
    point, the weights (bf16) and biases (fp32) read once."""
    flops = 2.0 * n * (IN_W * W + (n_layers - 1) * W * W)
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    nbytes = (n * (8 * 4 + OUT_W * out_bytes)
              + 2 * (IN_W * W + (n_layers - 1) * W * W) + 4 * n_layers * W)
    return flops, nbytes


def _check(variant: str, out_dtype):
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; one of {VARIANTS}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the probe writes bf16 or fp32, not {out_dtype}")


def fwd_probe_plain(in8: torch.Tensor, ops: ProbeOperands, variant: str = "full",
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel 3: fp32 products of bf16-rounded
    operands (exact in fp32, so the result does not depend on TF32)."""
    _check(variant, out_dtype)
    in8 = in8.float()
    if variant == "nope":
        feat = (in8[:, 0:1] * 0.01).expand(-1, IN_W)
    else:
        z = in8[:, 0:1] * ops.pe[0:1]
        for d in range(1, PE_ROWS):
            z = z + in8[:, d : d + 1] * ops.pe[d : d + 1]
        feat = z if variant == "nosin" else ops.sm * torch.sin(z) + (1.0 - ops.sm) * z
    h = feat
    for w, b in zip(ops.ws, ops.bs):
        o = h.to(torch.bfloat16).float() @ w
        if variant == "norelu":
            h = o
        elif variant == "nobias":
            h = torch.relu(o)
        else:
            h = torch.relu(o + b)
    return h[:, :OUT_W].to(out_dtype)


def fwd_probe(in8: torch.Tensor, ops: ProbeOperands, variant: str = "full", tile: int = 64,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """``[N, 8]`` fp32 -> ``[N, 128]`` in ``out_dtype``.  CPU tensors take
    the plain version (``tile`` is the card's and means nothing there);
    CUDA tensors launch kernel 3 with ``tile`` points per block on the
    operands' weight image (one launch, counted in ``fwd_probe.launches``)."""
    _check(variant, out_dtype)
    if in8.device.type == "cpu":
        return fwd_probe_plain(in8, ops, variant, out_dtype)
    if in8.device.type != "cuda":
        raise ValueError(f"fwd_probe: unsupported device {in8.device}")
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES} points per block, got {tile}")
    if in8.dtype != torch.float32 or in8.dim() != 2 or in8.shape[1] != 8:
        raise ValueError(f"in8 must be float32 [N, 8], got {in8.dtype} {tuple(in8.shape)}")
    if ops.wimg is None or ops.wimg.shape != ops.wbuf.shape:
        raise ValueError("fwd_probe on the card needs the operands' weight image "
                         "(probe_operands builds it for CUDA tensors)")
    for t in (ops.pe, ops.sm, ops.wimg, ops.bbuf):
        if t.device != in8.device:
            raise ValueError("probe operands must all lie on in8's device")
    from intrinsicnerf_tpu_torch.ops.build import load_library

    lib = load_library("fwd_probe")
    in8 = in8.contiguous()
    n = in8.shape[0]
    out = torch.empty((n, OUT_W), dtype=out_dtype, device=in8.device)
    if n == 0:
        return out
    with torch.cuda.device(in8.device):
        err = lib.fwd_probe(
            in8.data_ptr(), ops.pe.data_ptr(), ops.sm.data_ptr(),
            ops.wimg.data_ptr(), ops.bbuf.data_ptr(), out.data_ptr(), n, len(ops.ws),
            VARIANTS.index(variant), tile, int(out_dtype == torch.float32),
            torch.cuda.current_stream(in8.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fwd_probe launch failed: cudaError {err}")
    fwd_probe.launches += 1
    return out


fwd_probe.launches = 0
