"""Fused trunk + heads MLP: hand-written CUDA kernels for Hopper.

Port of ``intrinsicnerf_tpu/ops/fused_mlp.py``: the Pallas ``_fwd_kernel``
(launched by ``_run_fwd``) and ``_bwd_kernel`` (launched by
``_fused_bwd``), paired there by ``jax.custom_vjp`` and here by the
``torch.autograd.Function`` :class:`FusedMLP`.

Forward.  Kernel 1 (``csrc/fused_mlp_fwd.cu``) takes
a packed ``[P, 8]`` point block ``[x, y, z, dx, dy, dz, 1, 0]``, expands
the positional encoding on chip (``feat = m*sin(in8 @ F) + (1-m)*(in8 @
F)`` in fp32), runs the 8x256 skip trunk and the five heads with bf16
operands and fp32 accumulation, and writes one packed ``[P, 128]`` bf16
output: ``[0]=sigma, [1:4]=albedo_logit, [4]=shading_logit,
[5:8]=residual_logit, [8:8+C]=sem_logits``.  The caller applies the
sigmoids.  The output crosses device memory in bf16 as in the JAX
package: the logits carry bf16-matmul noise regardless.

``fused_mlp_forward`` is its wrapper.  It takes ``FusedOperands``, the
weights packed once (``fused_operands``; ``IntrinsicMLP`` keeps them
until its weights change), so a launch does no packing, casting or
host-to-device copy.  This is the serving path, without gradients.  The
kernel streams its weights from an image, every 64-row K-slab of the
blocks in the order its products consume them, laid out as the slab sits
in its shared-memory ring; ``fwd_weight_image`` builds it on the card
(with a small kernel of the same source) once per set of weights, and
``fwd_weight_image_plain`` builds the same bytes in PyTorch.

Backward.  Kernel 2 (``csrc/fused_mlp_bwd.cu``) takes the points and the
bf16 cotangent of the packed output, recomputes the forward and returns
fp32 gradients for all 38 packed blocks; ``fused_mlp_backward`` is its
wrapper.  The cotangent is bf16 because the output is, as in JAX
(``fused_mlp.py:57-65``).  The points and the PE constants get no
gradient, which is exact: NeRF samples are not parameters.

:class:`FusedMLP` differentiates through :class:`FlatBlocks`, the
kernels' own flat fp32 buffers: every weight block in ``_W_ORDER`` and
the biases in ``_B_ORDER`` then the one output-bias row.  Kernel 1's
bf16 weights are one cast of the weight buffer, and kernel 2's flat
``dw``/``db`` are the buffers' gradients as they stand.  The packed
training state (the twin of the JAX ``packs_state``) holds these
buffers, and the step projects their gradients with the
:func:`packed_grad_masks` mask.  The unpacked state keeps the
``nn.Linear`` parameters, which :func:`fused_mlp_apply` packs and
flattens (pads, slices, a concat and the sum of the five output-bias
rows), so autograd carries the flat gradients back to them, and the
backward of the pack keeps only the real parameter slots, which is the
same projection.

On a CPU tensor each wrapper runs its plain PyTorch version
(``fused_mlp_forward_plain``, ``fused_mlp_backward_plain``); on a CUDA
tensor it launches its kernel (counting the launch in
``fused_mlp_forward.launches`` / ``fused_mlp_backward.launches``) or
raises.  A launch made while the stream captures a CUDA graph is
recorded into the graph, not run, and counts in ``.captured`` instead:
the graph's replays run it without passing through the wrapper, so a
run counts them from its replays (``train/step.py:make_multi_step``).  The kernel libraries are compiled at first use by
``ops/build.py``; importing this module needs no compiler.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from intrinsicnerf_tpu_torch.core.compositing import RawOutputs

IN_W = 128  # packed PE width: pos-PE at 0, dir-PE at DIR_OFF
DIR_OFF = 64
OUT_W = 128
IN8_W = 8  # packed kernel input: [x, y, z, dx, dy, dz, 1, 0]
KERNEL_WIDTH = 256  # trunk width the CUDA kernel is compiled for

Packed = Dict[str, torch.Tensor]

_PACKED_KEYS = (
    "w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
    "w5x", "w5h", "b5", "w6", "b6", "w7", "b7",
    "w_sig", "b_sig", "w_a1", "b_a1", "w_a2", "b_a2",
    "w_s1", "b_s1", "w_s2", "b_s2", "w_f", "b_f",
    "wv_f", "wv_d", "b_v", "w_r", "b_r",
    "w_m1", "b_m1", "w_m2", "b_m2",
)
# the kernel's flat buffers (csrc/fused_mlp_fwd.cu reads them in this order)
_W_ORDER = (
    "w0", "w1", "w2", "w3", "w4", "w5x", "w5h", "w6", "w7",
    "w_sig", "w_a1", "w_a2", "w_s1", "w_s2", "w_f", "wv_f", "wv_d", "w_r",
    "w_m1", "w_m2",
)
_B_ORDER = ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7",
            "b_a1", "b_s1", "b_f", "b_v", "b_m1")
_B_OUT = ("b_sig", "b_a2", "b_s2", "b_r", "b_m2")  # summed into one out bias
W_TOTAL = 835_584  # bf16 weights in the flat buffer at the kernel's width
B_TOTAL = 2_944  # fp32 biases in the flat buffer at the kernel's width
# kernel 1's weight image: the blocks in the order its products stream them
# (csrc/fused_mlp_fwd.cu, SEG_TABLE), each as in/64 K-slabs of 64 rows
FWD_IMAGE_ORDER = (
    "w0", "w1", "w2", "w3", "w4", "w5h", "w5x", "w6", "w7",
    "w_sig", "w_f", "wv_f", "wv_d", "w_r", "w_a1", "w_a2", "w_s1", "w_s2",
    "w_m1", "w_m2",
)
FWD_IMAGE_SLABS = 66
# point chunks of kernel 2's weight-gradient GEMM: about SPLIT_ROWS points
# each, at most MAX_SPLITS, so that its 51 output tiles x 5 chunks = 255
# blocks run as one wave at two blocks per SM on the H100's 132 SMs
SPLIT_ROWS = 4096
MAX_SPLITS = 5


def pe_constants(cfg, device=None):
    """Frequency matrix F ``[8, 128]`` and sinusoid mask ``[1, 128]`` with
    ``feat = m*sin(in8 @ F) + (1-m)*(in8 @ F)`` equal to
    ``positional_encoding`` in the packed layout.  Cosines come from a
    pi/2 phase on the constant-1 input column."""
    F = torch.zeros(IN8_W, IN_W, dtype=torch.float32)
    m = torch.zeros(1, IN_W, dtype=torch.float32)

    def fill(col0, dim0, n_freqs, scale):
        col = col0
        for d in range(3):  # identity block
            F[dim0 + d, col + d] = 1.0 / scale
        col += 3
        for k in range(n_freqs):
            for trig in range(2):  # sin then cos
                for d in range(3):
                    F[dim0 + d, col] = (2.0**k) / scale
                    if trig == 1:
                        F[6, col] = math.pi / 2.0
                    m[0, col] = 1.0
                    col += 1

    fill(0, 0, cfg.n_freqs_pos, cfg.pos_scalar_factor)
    fill(DIR_OFF, 3, cfg.n_freqs_dir, 1.0)
    return F.to(device), m.to(device)


def _pad2(a, rows, cols, row_off=0, col_off=0):
    out = a.new_zeros((rows, cols), dtype=torch.float32)
    out[row_off : row_off + a.shape[0], col_off : col_off + a.shape[1]] = a
    return out


def _padb(b, cols, col_off=0):
    out = b.new_zeros((1, cols), dtype=torch.float32)
    out[0, col_off : col_off + b.shape[0]] = b
    return out


def pack_weights(sd: Mapping[str, torch.Tensor], cfg) -> Packed:
    """Model state_dict (reference keys, ``[out, in]`` weights) -> the
    dense padded ``[in, out]`` blocks the kernel consumes."""
    W = cfg.width
    H = W // 2
    in_ch = cfg.input_ch
    if cfg.depth != 8 or tuple(cfg.skips) != (4,):
        raise ValueError("fused kernel implements the reference architecture (D=8, skip 4)")
    if 8 + max(cfg.num_semantic_classes, 1) > OUT_W:
        raise ValueError("too many semantic classes for the packed output")
    if in_ch > DIR_OFF or cfg.input_ch_views > IN_W - DIR_OFF:
        raise ValueError("PE widths exceed the packed input slots")

    def k(name):  # [in, out]
        return sd[f"{name}.weight"].t()

    def b(name):
        return sd[f"{name}.bias"]

    p: Packed = {"w0": _pad2(k("pts_linears.0"), IN_W, W), "b0": _padb(b("pts_linears.0"), W)}
    for i in range(1, 5):
        p[f"w{i}"] = _pad2(k(f"pts_linears.{i}"), W, W)
        p[f"b{i}"] = _padb(b(f"pts_linears.{i}"), W)
    w5 = k("pts_linears.5")  # rows = [input_pts(63) | h(256)]
    p["w5x"] = _pad2(w5[:in_ch], IN_W, W)
    p["w5h"] = _pad2(w5[in_ch:], W, W)
    p["b5"] = _padb(b("pts_linears.5"), W)
    for i in (6, 7):
        p[f"w{i}"] = _pad2(k(f"pts_linears.{i}"), W, W)
        p[f"b{i}"] = _padb(b(f"pts_linears.{i}"), W)

    # second-stage head weights land in disjoint column slots of the
    # shared [*, OUT_W] output
    p["w_sig"] = _pad2(k("alpha_linear"), W, OUT_W, col_off=0)
    p["b_sig"] = _padb(b("alpha_linear"), OUT_W, col_off=0)
    p["w_a1"] = _pad2(k("albedo_linear1"), W, H)
    p["b_a1"] = _padb(b("albedo_linear1"), H)
    p["w_a2"] = _pad2(k("albedo_linear2"), H, OUT_W, col_off=1)
    p["b_a2"] = _padb(b("albedo_linear2"), OUT_W, col_off=1)
    p["w_s1"] = _pad2(k("shading_linear1"), W, H)
    p["b_s1"] = _padb(b("shading_linear1"), H)
    p["w_s2"] = _pad2(k("shading_linear2"), H, OUT_W, col_off=4)
    p["b_s2"] = _padb(b("shading_linear2"), OUT_W, col_off=4)
    p["w_f"] = _pad2(k("feature_linear"), W, W)
    p["b_f"] = _padb(b("feature_linear"), W)
    wv = k("views_linears.0")  # [W + in_ch_views, H]
    p["wv_f"] = _pad2(wv[:W], W, H)
    p["wv_d"] = _pad2(wv[W:], IN_W, H, row_off=DIR_OFF)
    p["b_v"] = _padb(b("views_linears.0"), H)
    p["w_r"] = _pad2(k("residual_linear"), H, OUT_W, col_off=5)
    p["b_r"] = _padb(b("residual_linear"), OUT_W, col_off=5)
    if cfg.enable_semantic:
        p["w_m1"] = _pad2(k("semantic_linear.0.0"), W, H)
        p["b_m1"] = _padb(b("semantic_linear.0.0"), H)
        p["w_m2"] = _pad2(k("semantic_linear.1"), H, OUT_W, col_off=8)
        p["b_m2"] = _padb(b("semantic_linear.1"), OUT_W, col_off=8)
    else:
        ref = p["w0"]
        p["w_m1"] = ref.new_zeros((W, H))
        p["b_m1"] = ref.new_zeros((1, H))
        p["w_m2"] = ref.new_zeros((H, OUT_W))
        p["b_m2"] = ref.new_zeros((1, OUT_W))
    return p


def unpack_weights(p: Packed, cfg) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_weights`: a state_dict with reference keys."""
    W = cfg.width
    H = W // 2
    C = cfg.num_semantic_classes
    in_ch, in_ch_views = cfg.input_ch, cfg.input_ch_views
    sd: Dict[str, torch.Tensor] = {}

    def lay(name, wk, bk, rows, cols, row_off=0, col_off=0):
        w = p[wk][row_off : row_off + rows, col_off : col_off + cols]
        sd[f"{name}.weight"] = w.t().contiguous()
        sd[f"{name}.bias"] = p[bk][0, col_off : col_off + cols].contiguous()

    lay("pts_linears.0", "w0", "b0", in_ch, W)
    for i in range(1, 5):
        lay(f"pts_linears.{i}", f"w{i}", f"b{i}", W, W)
    w5 = torch.cat([p["w5x"][:in_ch], p["w5h"][:W]], dim=0)
    sd["pts_linears.5.weight"] = w5.t().contiguous()
    sd["pts_linears.5.bias"] = p["b5"][0, :W].contiguous()
    for i in (6, 7):
        lay(f"pts_linears.{i}", f"w{i}", f"b{i}", W, W)
    lay("alpha_linear", "w_sig", "b_sig", W, 1)
    lay("albedo_linear1", "w_a1", "b_a1", W, H)
    lay("albedo_linear2", "w_a2", "b_a2", H, 3, col_off=1)
    lay("shading_linear1", "w_s1", "b_s1", W, H)
    lay("shading_linear2", "w_s2", "b_s2", H, 1, col_off=4)
    lay("feature_linear", "w_f", "b_f", W, W)
    wv = torch.cat([p["wv_f"][:W], p["wv_d"][DIR_OFF : DIR_OFF + in_ch_views]], dim=0)
    sd["views_linears.0.weight"] = wv.t().contiguous()
    sd["views_linears.0.bias"] = p["b_v"][0, :H].contiguous()
    lay("residual_linear", "w_r", "b_r", H, 3, col_off=5)
    if cfg.enable_semantic:
        lay("semantic_linear.0.0", "w_m1", "b_m1", W, H)
        lay("semantic_linear.1", "w_m2", "b_m2", H, C, col_off=8)
    return sd


def is_packed(params) -> bool:
    """True when ``params`` is already the kernel's packed dict."""
    return isinstance(params, Mapping) and "w0" in params and "pts_linears.0.weight" not in params


def packed_grad_masks(params: Mapping[str, torch.Tensor], cfg) -> Packed:
    """0/1 masks over the packed blocks marking real parameter slots: the
    pack of all-ones parameters.  The padded slots (e.g. ``w_sig[:, 1:]``,
    which alias other heads' output columns) get nonzero gradients from
    the shared output product; the backward of :func:`pack_weights` drops
    them, so gradients that reach the parameters equal the packed
    gradients times these masks."""
    return pack_weights({k: torch.ones_like(v) for k, v in params.items()}, cfg)


class FlatBlocks(NamedTuple):
    """The packed blocks as the kernels' two flat fp32 buffers: the packed
    training state's layout."""

    weight: torch.Tensor  # every weight block [in, out] row-major, in _W_ORDER
    bias: torch.Tensor  # _B_ORDER, then the output-bias row the five heads share


def block_shapes(width: int) -> Dict[str, Tuple[int, int]]:
    """``[in, out]`` of each packed block at trunk width ``width`` (a bias
    block is ``[1, out]``; the output-bias heads are one ``OUT_W`` row in
    the flat layout)."""
    w, h = width, width // 2
    shapes = {"w0": (IN_W, w), "w1": (w, w), "w2": (w, w), "w3": (w, w), "w4": (w, w),
              "w5x": (IN_W, w), "w5h": (w, w), "w6": (w, w), "w7": (w, w),
              "w_sig": (w, OUT_W), "w_a1": (w, h), "w_a2": (h, OUT_W), "w_s1": (w, h),
              "w_s2": (h, OUT_W), "w_f": (w, w), "wv_f": (w, h), "wv_d": (IN_W, h),
              "w_r": (h, OUT_W), "w_m1": (w, h), "w_m2": (h, OUT_W)}
    for k in _B_ORDER:
        shapes[k] = (1, h if k in ("b_a1", "b_s1", "b_v", "b_m1") else w)
    return shapes


def _out_slots(cfg) -> Dict[str, Tuple[int, int]]:
    """Each output-bias head's columns of the shared output row."""
    c = cfg.num_semantic_classes if cfg.enable_semantic else 0
    return {"b_sig": (0, 1), "b_a2": (1, 4), "b_s2": (4, 5), "b_r": (5, 8), "b_m2": (8, 8 + c)}


def flatten_blocks(p: Packed) -> FlatBlocks:
    """Packed blocks -> :class:`FlatBlocks`; the output-bias row is the
    sum of the five heads' rows, whose slots are disjoint."""
    b_out = p[_B_OUT[0]]
    for k in _B_OUT[1:]:
        b_out = b_out + p[k]
    return FlatBlocks(torch.cat([p[k].reshape(-1) for k in _W_ORDER]).float(),
                      torch.cat([p[k].reshape(-1) for k in _B_ORDER]
                                + [b_out.reshape(-1)]).float())


def flat_blocks(flat: FlatBlocks, cfg) -> Packed:
    """Inverse of :func:`flatten_blocks`: the weight and inner-bias blocks
    as views of the buffers, and each output-bias head as its own slots of
    the shared row (zero elsewhere), as :func:`pack_weights` lays it."""
    shapes = block_shapes(cfg.width)
    p: Packed = {}
    for buf, keys in ((flat.weight, _W_ORDER), (flat.bias, _B_ORDER)):
        i = 0
        for k in keys:
            rows, cols = shapes[k]
            p[k] = buf[i : i + rows * cols].view(rows, cols)
            i += rows * cols
        want = i + (OUT_W if buf is flat.bias else 0)
        if buf.shape != (want,):
            raise ValueError(f"flat buffer of {tuple(buf.shape)} does not fit width "
                             f"{cfg.width} ({want} values)")
    out = flat.bias[-OUT_W:].view(1, OUT_W)
    for k, (s, e) in _out_slots(cfg).items():
        p[k] = torch.zeros_like(out)
        p[k][:, s:e] = out[:, s:e]
    return {k: p[k] for k in _PACKED_KEYS}


def _flat(params, cfg) -> FlatBlocks:
    """``params`` (:class:`FlatBlocks`, an already-packed dict, or a model
    state_dict / ``named_parameters`` dict) as :class:`FlatBlocks`,
    differentiable through the pack."""
    if isinstance(params, FlatBlocks):
        return params
    return flatten_blocks(params if is_packed(params) else pack_weights(params, cfg))


def build_in8(pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """``[N, S, 3]`` pts + ``[N, 3]`` dirs -> packed ``[N*S, 8]`` input
    ``[x, y, z, dx, dy, dz, 1, 0]``.  ``viewdirs`` is required: the
    constant-1 phase column makes zero dirs encode as cos(0)=1."""
    if viewdirs is None:
        raise ValueError(
            "fused kernel requires viewdirs; use models.mlp.eval_points "
            "(unfused path) for the viewdirs-off architecture"
        )
    n, s, _ = pts.shape
    out = pts.new_zeros((n, s, IN8_W), dtype=torch.float32)
    out[..., 0:3] = pts
    out[..., 3:6] = viewdirs[:, None, :]
    out[..., 6] = 1.0
    return out.reshape(n * s, IN8_W)


def _mm(a, b):
    """bf16 operands, fp32 accumulation.  Products of bf16 values are exact
    in fp32 (and in TF32), so the result does not depend on allow_tf32."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _mm_tn(a, b):
    """``a.T @ b`` with bf16 operands and fp32 accumulation (dW)."""
    return a.to(torch.bfloat16).float().t() @ b.to(torch.bfloat16).float()


def _mm_nt(a, b):
    """``a @ b.T`` with bf16 operands and fp32 accumulation (input grads)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().t()


def _pe_feat(pe_consts, in8: torch.Tensor) -> torch.Tensor:
    """``[P, 8]`` -> ``[P, 128]`` PE features.  The angles are 8
    elementwise fp32 multiply-adds, never a matmul."""
    F, m = pe_consts
    z = in8[:, 0:1] * F[0]
    for k in range(1, IN8_W):
        z = z + in8[:, k : k + 1] * F[k]
    return m * torch.sin(z) + (1.0 - m) * z


def _forward_tile(w: Packed, feat: torch.Tensor, want_out: bool = True):
    """Mirrors the Pallas ``_forward_tile``: returns (out or None, saved
    activations).  ``want_out=False`` skips the five output products, as
    the backward's recompute does."""
    relu = torch.relu
    h = relu(_mm(feat, w["w0"]) + w["b0"])
    acts = [h]
    for i in range(1, 5):
        h = relu(_mm(h, w[f"w{i}"]) + w[f"b{i}"])
        acts.append(h)
    h = relu(_mm(h, w["w5h"]) + _mm(feat, w["w5x"]) + w["b5"])
    acts.append(h)
    h = relu(_mm(h, w["w6"]) + w["b6"])
    acts.append(h)
    H = relu(_mm(h, w["w7"]) + w["b7"])
    acts.append(H)
    a1 = relu(_mm(H, w["w_a1"]) + w["b_a1"])
    s1 = relu(_mm(H, w["w_s1"]) + w["b_s1"])
    m1 = relu(_mm(H, w["w_m1"]) + w["b_m1"])
    f = _mm(H, w["w_f"]) + w["b_f"]
    v = relu(_mm(f, w["wv_f"]) + _mm(feat, w["wv_d"]) + w["b_v"])
    out = None
    if want_out:
        out = (
            _mm(H, w["w_sig"]) + w["b_sig"]
            + _mm(a1, w["w_a2"]) + w["b_a2"]
            + _mm(s1, w["w_s2"]) + w["b_s2"]
            + _mm(v, w["w_r"]) + w["b_r"]
            + _mm(m1, w["w_m2"]) + w["b_m2"]
        )
    return out, {"acts": acts, "a1": a1, "s1": s1, "m1": m1, "f": f, "v": v}


def fused_mlp_forward_plain(packed: Packed, pe_consts, in8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 1: ``[P, 8]`` -> ``[P, 128]`` bf16.
    Mirrors the Pallas ``_forward_tile``; activations are rounded to bf16
    where ``_mm`` casts them."""
    out, _ = _forward_tile(packed, _pe_feat(pe_consts, in8))
    return out.to(torch.bfloat16)


def fused_mlp_backward_plain(packed: Packed, pe_consts, in8: torch.Tensor,
                             g: torch.Tensor) -> Packed:
    """Plain PyTorch version of kernel 2: the fp32 gradients of all packed
    blocks for the cotangent ``g`` ``[P, 128]`` of the packed output.

    Mirrors the Pallas ``_bwd_kernel`` step by step, not autograd through
    the forward (whose bf16 casts would round the gradients elsewhere):
    every product rounds its operands to bf16, gradients included
    (``ga1``, ``gh``, ...), and accumulates in fp32; each bias gradient is
    the fp32 sum of the unrounded fp32 gradient."""
    w = packed
    feat = _pe_feat(pe_consts, in8)
    _, st = _forward_tile(w, feat, want_out=False)
    acts = st["acts"]
    H = acts[7]
    go = g.float()
    grads: Packed = {}

    def acc(wk, bk, a, gb):
        grads[wk] = _mm_tn(a, gb)
        grads[bk] = gb.sum(dim=0, keepdim=True)

    dH = _mm_nt(go, w["w_sig"])
    acc("w_sig", "b_sig", H, go)
    for w2, b2, w1, b1, a in (("w_a2", "b_a2", "w_a1", "b_a1", "a1"),
                              ("w_s2", "b_s2", "w_s1", "b_s1", "s1"),
                              ("w_m2", "b_m2", "w_m1", "b_m1", "m1")):
        g1 = _mm_nt(go, w[w2]) * (st[a] > 0)
        acc(w2, b2, st[a], go)
        dH = dH + _mm_nt(g1, w[w1])
        acc(w1, b1, H, g1)
    gv = _mm_nt(go, w["w_r"]) * (st["v"] > 0)
    acc("w_r", "b_r", st["v"], go)
    gf = _mm_nt(gv, w["wv_f"])
    grads["wv_f"] = _mm_tn(st["f"], gv)
    grads["wv_d"] = _mm_tn(feat, gv)
    grads["b_v"] = gv.sum(dim=0, keepdim=True)
    dH = dH + _mm_nt(gf, w["w_f"])
    acc("w_f", "b_f", H, gf)

    gh = dH * (H > 0)
    acc("w7", "b7", acts[6], gh)
    gh = _mm_nt(gh, w["w7"]) * (acts[6] > 0)
    acc("w6", "b6", acts[5], gh)
    gh = _mm_nt(gh, w["w6"]) * (acts[5] > 0)
    grads["w5h"] = _mm_tn(acts[4], gh)
    grads["w5x"] = _mm_tn(feat, gh)
    grads["b5"] = gh.sum(dim=0, keepdim=True)
    gh = _mm_nt(gh, w["w5h"]) * (acts[4] > 0)
    for i in range(4, 0, -1):
        acc(f"w{i}", f"b{i}", acts[i - 1], gh)
        gh = _mm_nt(gh, w[f"w{i}"]) * (acts[i - 1] > 0)
    grads["w0"] = _mm_tn(feat, gh)
    grads["b0"] = gh.sum(dim=0, keepdim=True)
    return {k: grads[k] for k in _PACKED_KEYS}


def kernel_buffers(packed):
    """The kernel's flat operands: all weights as one bf16 buffer (each
    block ``[in, out]`` row-major, in ``_W_ORDER``) and all biases as one
    fp32 buffer (``_B_ORDER`` then the summed output bias), from packed
    blocks or from :class:`FlatBlocks`, which hold that layout already."""
    flat = packed if isinstance(packed, FlatBlocks) else flatten_blocks(packed)
    return flat.weight.detach().to(torch.bfloat16), flat.bias.detach()


def swizzled_slabs(block: torch.Tensor) -> torch.Tensor:
    """``block [K, N]`` (both multiples of 64) as a weight image lays it
    out, flat: each K-slab (64 rows) as N/64 atoms of 64 rows by 64
    columns, row r of an atom holding its eight 16-byte chunks at
    positions chunk ^ (r % 8) (the 128-byte swizzle)."""
    rows, cols = block.shape
    r = torch.arange(64, device=block.device)[:, None]
    chunk_at = torch.arange(8, device=block.device)[None, :] ^ (r & 7)  # [row, position]
    x = block.reshape(rows // 64, 64, cols // 64, 8, 8).permute(0, 2, 1, 3, 4)
    return x[:, :, r, chunk_at].reshape(-1)  # [slab, atom, row, position, 8]


def _count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, or one more recorded into
    a CUDA graph when the current stream is capturing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def fwd_weight_image_plain(wbuf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 1's weight image: the swizzled
    K-slabs of each block of ``FWD_IMAGE_ORDER`` (W ``[in, out]``)."""
    shapes = block_shapes(KERNEL_WIDTH)
    blocks, i = {}, 0
    for k in _W_ORDER:
        rows, cols = shapes[k]
        blocks[k] = wbuf[i : i + rows * cols].view(rows, cols)
        i += rows * cols
    return torch.cat([swizzled_slabs(blocks[k]) for k in FWD_IMAGE_ORDER])


def fwd_weight_image(wbuf: torch.Tensor) -> torch.Tensor:
    """Kernel 1's weight image of the flat bf16 weights ``wbuf``.

    CPU tensors take the plain version; CUDA tensors launch
    ``fwd_wimg_kernel`` (one launch, counted in
    ``fwd_weight_image.launches``)."""
    if wbuf.dtype != torch.bfloat16 or wbuf.shape != (W_TOTAL,):
        raise ValueError(f"the kernel's weights must be bfloat16 [{W_TOTAL}], got "
                         f"{wbuf.dtype} {tuple(wbuf.shape)}")
    if wbuf.device.type == "cpu":
        return fwd_weight_image_plain(wbuf)
    if wbuf.device.type != "cuda":
        raise ValueError(f"fused MLP: unsupported device {wbuf.device}")
    from intrinsicnerf_tpu_torch.ops.build import load_library

    lib = load_library("fused_mlp_fwd")
    wbuf = wbuf.contiguous()
    img = torch.empty_like(wbuf)
    with torch.cuda.device(wbuf.device):
        err = lib.fused_mlp_fwd_image(wbuf.data_ptr(), img.data_ptr(),
                                      torch.cuda.current_stream(wbuf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd_image launch failed: cudaError {err}")
    _count_launch(fwd_weight_image)
    return img


fwd_weight_image.launches = fwd_weight_image.captured = 0


class FusedOperands(NamedTuple):
    """Everything the fused forward reads besides the points, made once
    per set of weights by :func:`fused_operands`."""

    packed: Optional[Packed]  # fp32 [in, out] blocks: the plain version's operands
    pe: Tuple[torch.Tensor, torch.Tensor]  # pe_mat [8, 128], sin_mask [1, 128]
    wbuf: torch.Tensor  # the kernels' flat bf16 weights
    bbuf: torch.Tensor  # the kernels' flat fp32 biases
    wimg: Optional[torch.Tensor] = None  # kernel 1's weight image (on the card)


def _image_for(wbuf: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Kernel 1's weight image where the kernel can take ``wbuf``: on the
    card at the kernel's width (elsewhere the forward takes the plain
    version, or raises)."""
    if wbuf is None or wbuf.device.type != "cuda" or wbuf.numel() != W_TOTAL:
        return None
    return fwd_weight_image(wbuf)


def fused_operands(params, cfg, device) -> FusedOperands:
    """Pack ``params`` (a model state_dict, an already-packed dict or
    :class:`FlatBlocks`) on their device, build the PE constants on
    ``device`` and, on the card, kernel 1's weight image."""
    flat = _flat(params, cfg)
    flat = FlatBlocks(flat.weight.detach(), flat.bias.detach())
    wbuf, bbuf = kernel_buffers(flat)
    return FusedOperands(flat_blocks(flat, cfg), pe_constants(cfg, device), wbuf, bbuf,
                         _image_for(wbuf))


def _check_cuda_operands(ops: FusedOperands, in8: torch.Tensor):
    if in8.dtype != torch.float32 or in8.dim() != 2 or in8.shape[1] != IN8_W:
        raise ValueError(f"in8 must be float32 [P, {IN8_W}], got {in8.dtype} {tuple(in8.shape)}")
    if ops.wbuf.shape != (W_TOTAL,) or ops.bbuf.shape != (B_TOTAL,):
        raise ValueError(
            f"the CUDA kernel is built for width {KERNEL_WIDTH} ({W_TOTAL} weights, "
            f"{B_TOTAL} biases), got {tuple(ops.wbuf.shape)} and {tuple(ops.bbuf.shape)}"
        )
    for t in (*ops.pe, ops.wbuf, ops.bbuf):
        if t.device != in8.device:
            raise ValueError("fused MLP operands must all lie on in8's device")


def fused_mlp_forward(ops: FusedOperands, in8: torch.Tensor) -> torch.Tensor:
    """``[P, 8]`` fp32 -> ``[P, 128]`` bf16 packed raw outputs.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch, counted in ``fused_mlp_forward.launches``)."""
    if in8.device.type == "cpu":
        return fused_mlp_forward_plain(ops.packed, ops.pe, in8)
    if in8.device.type != "cuda":
        raise ValueError(f"fused MLP: unsupported device {in8.device}")
    _check_cuda_operands(ops, in8)
    if ops.wimg is None or ops.wimg.device != in8.device:
        raise ValueError("kernel 1 needs its weight image on in8's device (fused_operands)")
    from intrinsicnerf_tpu_torch.ops.build import load_library

    lib = load_library("fused_mlp_fwd")
    in8 = in8.contiguous()
    pe_mat, sin_mask = (t.float().contiguous() for t in ops.pe)
    n = in8.shape[0]
    out = torch.empty((n, OUT_W), dtype=torch.bfloat16, device=in8.device)
    if n == 0:
        return out
    with torch.cuda.device(in8.device):
        err = lib.fused_mlp_fwd(
            in8.data_ptr(), pe_mat.data_ptr(), sin_mask.data_ptr(),
            ops.wimg.data_ptr(), ops.bbuf.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(in8.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {err}")
    _count_launch(fused_mlp_forward)
    return out


fused_mlp_forward.launches = fused_mlp_forward.captured = 0


def backward_splits(n: int) -> int:
    """Point chunks of kernel 2's weight products for ``n`` points: about
    SPLIT_ROWS points each, at most MAX_SPLITS (its fp32 workspace is
    splits x 3.3 MB).  The chunks fix the order of the fp32 sums, so they
    depend on ``n`` alone."""
    p_pad = -(-n // 64) * 64
    return max(1, min(MAX_SPLITS, -(-p_pad // SPLIT_ROWS)))


def _unflatten_grads(dw: torch.Tensor, db: torch.Tensor, packed: Packed) -> Packed:
    """Kernel 2's flat gradients (the layouts of ``kernel_buffers``) ->
    one tensor per packed block; each output bias gets the out-bias
    gradient, as ``_bwd_kernel`` adds ``sum(go)`` to each."""
    grads: Packed = {}
    i = 0
    for k in _W_ORDER:
        size = packed[k].numel()
        grads[k] = dw[i : i + size].view(packed[k].shape)
        i += size
    i = 0
    for k in _B_ORDER:
        size = packed[k].numel()
        grads[k] = db[i : i + size].view(packed[k].shape)
        i += size
    for k in _B_OUT:
        grads[k] = db[i : i + OUT_W].view(1, OUT_W)
    return {k: grads[k] for k in _PACKED_KEYS}


def _flatten_grads(grads: Packed):
    """Inverse of :func:`_unflatten_grads`: the blocks' gradients in
    kernel 2's flat layouts (the output bias's is any head's, as all five
    carry it)."""
    return (torch.cat([grads[k].reshape(-1) for k in _W_ORDER]),
            torch.cat([grads[k].reshape(-1) for k in _B_ORDER] + [grads[_B_OUT[0]].reshape(-1)]))


def fused_mlp_backward_flat(ops: FusedOperands, in8: torch.Tensor, g: torch.Tensor):
    """fp32 gradients ``(dw, db)`` of the kernels' flat weight and bias
    buffers (the layouts of :func:`kernel_buffers`, and so of
    :class:`FlatBlocks`) for the bf16 cotangent ``g`` ``[P, 128]`` of the
    packed output at the points ``in8``.

    CPU tensors take the plain version; CUDA tensors launch kernel 2 (one
    launch, counted in ``fused_mlp_backward.launches``).  Two launches on
    the same inputs give bitwise-equal gradients."""
    if in8.device.type == "cpu":
        return _flatten_grads(fused_mlp_backward_plain(ops.packed, ops.pe, in8, g))
    if in8.device.type != "cuda":
        raise ValueError(f"fused MLP: unsupported device {in8.device}")
    _check_cuda_operands(ops, in8)
    n = in8.shape[0]
    if g.dtype != torch.bfloat16 or tuple(g.shape) != (n, OUT_W) or g.device != in8.device:
        raise ValueError(f"g must be bfloat16 [{n}, {OUT_W}] on {in8.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    from intrinsicnerf_tpu_torch.ops.build import load_library

    lib = load_library("fused_mlp_bwd")
    dev = in8.device
    new = torch.zeros if n == 0 else torch.empty
    dw = new(ops.wbuf.numel(), dtype=torch.float32, device=dev)  # the weight layout
    db = new(ops.bbuf.numel(), dtype=torch.float32, device=dev)  # the bias layout
    if n == 0:
        return dw, db
    in8, g = in8.contiguous(), g.contiguous()
    pe_mat, sin_mask = (t.float().contiguous() for t in ops.pe)
    splits = backward_splits(n)
    sizes = [ctypes.c_longlong() for _ in range(3)]
    lib.fused_mlp_bwd_scratch(n, splits, *(ctypes.byref(x) for x in sizes))
    arena = torch.empty(sizes[0].value, dtype=torch.bfloat16, device=dev)
    bpart = torch.empty(sizes[1].value, dtype=torch.float32, device=dev)
    ws = torch.empty(sizes[2].value, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_mlp_bwd(
            in8.data_ptr(), pe_mat.data_ptr(), sin_mask.data_ptr(), ops.wbuf.data_ptr(),
            ops.bbuf.data_ptr(), g.data_ptr(), arena.data_ptr(), bpart.data_ptr(),
            ws.data_ptr(), dw.data_ptr(), db.data_ptr(), n, splits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd launch failed: cudaError {err}")
    _count_launch(fused_mlp_backward)
    return dw, db


def fused_mlp_backward(ops: FusedOperands, in8: torch.Tensor, g: torch.Tensor) -> Packed:
    """:func:`fused_mlp_backward_flat` as one fp32 gradient per packed
    block, for the checks of kernel 2 against its plain version."""
    return _unflatten_grads(*fused_mlp_backward_flat(ops, in8, g), ops.packed)


fused_mlp_backward.launches = fused_mlp_backward.captured = 0


class FusedMLP(torch.autograd.Function):
    """The fused MLP with its gradient: ``(in8, pe_mat, sin_mask, weight,
    bias, cfg)`` -> ``[P, 128]`` bf16, with ``weight`` and ``bias`` the
    buffers of :class:`FlatBlocks`.  On the card the forward casts
    ``weight`` to bf16 once and builds kernel 1's image from it, and
    kernel 2's ``dw``/``db`` are the buffers' gradients as they stand; on
    CPU tensors the plain versions run on views of the buffers.  The
    points and the PE constants get no gradient."""

    @staticmethod
    def _operands(in8, pe_mat, sin_mask, weight, bias, cfg, wbuf=None):
        """Kernel 2's operands (the plain versions' blocks on the host)."""
        flat = FlatBlocks(weight.detach(), bias.detach())
        if in8.device.type != "cuda":
            return FusedOperands(flat_blocks(flat, cfg), (pe_mat, sin_mask), None, None)
        wbuf = wbuf if wbuf is not None else kernel_buffers(flat)[0]
        return FusedOperands(None, (pe_mat, sin_mask), wbuf, flat.bias)

    @staticmethod
    def forward(ctx, in8, pe_mat, sin_mask, weight, bias, cfg):
        ops = FusedMLP._operands(in8, pe_mat, sin_mask, weight, bias, cfg)
        ops = ops._replace(wimg=_image_for(ops.wbuf))  # kernel 1's alone
        ctx.save_for_backward(in8, pe_mat, sin_mask, weight, bias)
        ctx.cfg, ctx.wbuf = cfg, ops.wbuf
        return fused_mlp_forward(ops, in8)

    @staticmethod
    def backward(ctx, g):
        in8, pe_mat, sin_mask, weight, bias = ctx.saved_tensors
        ops = FusedMLP._operands(in8, pe_mat, sin_mask, weight, bias, ctx.cfg, ctx.wbuf)
        dw, db = fused_mlp_backward_flat(ops, in8, g.to(torch.bfloat16))
        return None, None, None, dw, db, None


def fused_mlp_apply(params, cfg, in8: torch.Tensor, pe=None) -> torch.Tensor:
    """``[P, 8]`` point block -> ``[P, 128]`` fp32 raw outputs.

    ``params`` is ``FusedOperands`` (packed once, no gradient: the serving
    path), or anything :func:`fused_operands` takes, differentiated
    through :class:`FusedMLP`: the packed training state's
    :class:`FlatBlocks` as they are, a state_dict / ``named_parameters``
    dict or an already-packed dict packed and flattened here.  ``pe``
    overrides the PE constants built on ``in8``'s device."""
    if isinstance(params, FusedOperands):
        return fused_mlp_forward(params, in8).float()
    F, m = pe if pe is not None else pe_constants(cfg, in8.device)
    flat = _flat(params, cfg)
    return FusedMLP.apply(in8, F, m, flat.weight, flat.bias, cfg).float()


def fused_eval_points(params, cfg, pts: torch.Tensor, viewdirs: torch.Tensor,
                      pe=None) -> RawOutputs:
    """Drop-in for ``models.mlp.eval_points`` on the reference
    architecture (D=8, skip 4, viewdirs on); ``params`` and ``pe`` as in
    :func:`fused_mlp_apply`."""
    n, s, _ = pts.shape
    c = cfg.num_semantic_classes
    out = fused_mlp_apply(params, cfg, build_in8(pts, viewdirs), pe).reshape(n, s, OUT_W)
    albedo = torch.sigmoid(out[..., 1:4])
    shading = torch.sigmoid(out[..., 4])
    residual = torch.sigmoid(out[..., 5:8])
    return RawOutputs(
        rgb=albedo * shading[..., None] + residual,
        sigma=out[..., 0],
        albedo=albedo,
        shading=shading,
        residual=residual,
        sem_logits=out[..., 8 : 8 + c] if cfg.enable_semantic else None,
        endpoint_feat=None,
    )
