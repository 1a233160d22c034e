"""Kernel 1's weight image, on the CPU.

Kernel 1 (``ops/csrc/fused_mlp_fwd.cu``) streams its weights from an
image: every 64-row K-slab of the 20 packed blocks, in the order its
products consume them, each laid out as the slab sits in a stage of its
shared-memory ring (64-column atoms, 128-byte swizzle: the 16-byte chunk
c of row r sits at chunk position c ^ (r % 8)).  The card builds it with
``fwd_wimg_kernel``; ``fused_mlp.fwd_weight_image_plain`` builds the same
bytes in PyTorch, and ``chip_smoke.py`` holds the two equal on the card.
These tests hold the plain image's layout: undone slab by slab with the
inverse swizzle, it gives back every block of the flat weight buffer
exactly, and its slab order, slab count and size are the kernel's own
(parsed from the CUDA source, so that a change on one side fails here).
"""

import os
import re

import numpy as np
import pytest
import torch

from intrinsicnerf_tpu_torch.models.mlp import IntrinsicMLP, MLPConfig
from intrinsicnerf_tpu_torch.ops import build
from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

SOURCE = os.path.join(build.CSRC, "fused_mlp_fwd.cu")
# the source's weight-block offsets -> the packed blocks' names
OFFSETS = {"OFF_W0": "w0", "OFF_W1": "w1", "OFF_W2": "w2", "OFF_W3": "w3", "OFF_W4": "w4",
           "OFF_W5X": "w5x", "OFF_W5H": "w5h", "OFF_W6": "w6", "OFF_W7": "w7",
           "OFF_WSIG": "w_sig", "OFF_WA1": "w_a1", "OFF_WA2": "w_a2", "OFF_WS1": "w_s1",
           "OFF_WS2": "w_s2", "OFF_WF": "w_f", "OFF_WVF": "wv_f", "OFF_WVD": "wv_d",
           "OFF_WR": "w_r", "OFF_WM1": "w_m1", "OFF_WM2": "w_m2"}
WIDTHS = {"IN_W": fm.IN_W, "W": fm.KERNEL_WIDTH, "HW": fm.KERNEL_WIDTH // 2, "OUT_W": fm.OUT_W}


def _source():
    with open(SOURCE) as f:
        return f.read()


def _kernel_segments():
    """(block name, K, N) of each entry of the kernel's SEG_TABLE, in order."""
    table = re.search(r"#define SEG_TABLE(.*?)\nconstexpr", _source(), re.S).group(1)
    return [(OFFSETS[off], WIDTHS[k], WIDTHS[n])
            for off, k, n in re.findall(r"SEG\((OFF_\w+),\s*(\w+),\s*(\w+)\)", table)]


def _constant(name):
    return int(re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;", _source()).group(1))


def _flat_weights(seed, n_classes):
    cfg = MLPConfig(pos_scalar_factor=10.0, enable_semantic=True,
                    num_semantic_classes=n_classes, use_fused_kernel=True)
    model = IntrinsicMLP(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    model.load_state_dict({k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                           for k, v in model.state_dict().items()})
    packed = fm.pack_weights(model.state_dict(), cfg)
    wbuf, _ = fm.kernel_buffers(packed)
    return wbuf, packed


def _unswizzle(slab: np.ndarray, k_rows: int, n_cols: int) -> np.ndarray:
    """One stage's bytes (as bf16 bits) -> the [64, N] rows of W it holds,
    element by element from the layout's definition."""
    out = np.empty((k_rows, n_cols), dtype=slab.dtype)
    for atom in range(n_cols // 64):
        for r in range(k_rows):
            for pos in range(8):
                c = pos ^ (r % 8)  # the chunk stored at this position
                src = atom * 64 * 64 + r * 64 + pos * 8
                out[r, atom * 64 + c * 8: atom * 64 + c * 8 + 8] = slab[src: src + 8]
    return out


def test_segment_order_matches_the_kernel():
    assert [name for name, _, _ in _kernel_segments()] == list(fm.FWD_IMAGE_ORDER)
    assert sorted(fm.FWD_IMAGE_ORDER) == sorted(fm._W_ORDER)  # every block once


def test_slab_count_and_size_match_the_kernel():
    segs = _kernel_segments()
    slabs = sum(k // 64 for _, k, _ in segs)
    elems = sum(k * n for _, k, n in segs)
    assert slabs == _constant("FWD_SLABS") == fm.FWD_IMAGE_SLABS == 66
    assert elems == _constant("FWD_IMG_ELEMS") == 835_584
    wbuf, _ = _flat_weights(0, 7)
    img = fm.fwd_weight_image_plain(wbuf)
    assert img.dtype == torch.bfloat16 and img.shape == (elems,) == wbuf.shape


@pytest.mark.parametrize("seed,n_classes", [(0, 7), (1, 7), (0, 27), (1, 27)])
def test_plain_image_unswizzles_to_every_block(seed, n_classes):
    wbuf, packed = _flat_weights(seed, n_classes)
    img = fm.fwd_weight_image_plain(wbuf).view(torch.int16).numpy()
    blocks = {k: packed[k].to(torch.bfloat16).view(torch.int16).numpy() for k in fm._W_ORDER}
    off = 0
    for name, k_rows, n_cols in _kernel_segments():
        assert blocks[name].shape == (k_rows, n_cols), name
        got = np.concatenate([_unswizzle(img[off + s * 64 * n_cols: off + (s + 1) * 64 * n_cols],
                                         64, n_cols) for s in range(k_rows // 64)])
        np.testing.assert_array_equal(got, blocks[name], err_msg=name)
        off += k_rows * n_cols
    assert off == img.size


def test_image_wrapper_takes_the_plain_version_on_the_cpu():
    wbuf, _ = _flat_weights(2, 27)
    before = fm.fwd_weight_image.launches
    assert torch.equal(fm.fwd_weight_image(wbuf), fm.fwd_weight_image_plain(wbuf))
    assert fm.fwd_weight_image.launches == before  # the plain version counts no launch
    with pytest.raises(ValueError, match="weights"):
        fm.fwd_weight_image(wbuf[:-1])
