"""Kernel 3's weight image and tile set, on the CPU.

Kernel 3 (``ops/csrc/fwd_probe.cu``, the forward-attribution probe)
streams its weights from an image: every 64-row K-slab of the stacked
weights (two of ``W_0 [128, 256]``, then four of each ``W_i [256, 256]``),
each laid out as the slab sits in a stage of its shared-memory ring (four
64-column atoms, 128-byte swizzle: the 16-byte chunk c of row r sits at
chunk position c ^ (r % 8)).  The card builds it with
``probe_wimg_kernel``; ``fwd_probe.probe_weight_image_plain`` builds the
same bytes in PyTorch, and ``chip_smoke.py`` holds the two equal on the
card.  These tests hold the plain image's layout: undone slab by slab
with the inverse swizzle, it gives back every weight exactly; its slab
count and size are the kernel's; the wrapper's tile set is the one the
kernel's dispatch takes (parsed from the CUDA source, so that a change on
one side fails here); and the CPU path needs no image.
"""

import os
import re

import numpy as np
import pytest
import torch

from intrinsicnerf_tpu_torch.ops import build
from intrinsicnerf_tpu_torch.ops import fwd_probe as fp

SOURCE = os.path.join(build.CSRC, "fwd_probe.cu")
SLAB_BYTES = 64 * fp.W * 2


def _unswizzle(slab: np.ndarray) -> np.ndarray:
    """One stage's bytes (as bf16 bits) -> the [64, 256] rows it holds,
    element by element from the layout's definition."""
    out = np.empty((64, fp.W), dtype=slab.dtype)
    for atom in range(fp.W // 64):
        for r in range(64):
            for pos in range(8):
                c = pos ^ (r % 8)  # the chunk stored at this position
                src = atom * 64 * 64 + r * 64 + pos * 8
                out[r, atom * 64 + c * 8: atom * 64 + c * 8 + 8] = slab[src: src + 8]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_layers", [1, 2, 8, 16])
def test_plain_image_unswizzles_to_every_weight(n_layers, seed):
    _, ops = fp.probe_inputs(n_layers, n=1, seed=seed, device="cpu")
    img = fp.probe_weight_image_plain(ops.wbuf, n_layers).view(torch.int16).numpy()
    stacked = np.concatenate([w.to(torch.bfloat16).view(torch.int16).numpy() for w in ops.ws])
    n_slabs = stacked.shape[0] // 64
    got = np.concatenate([_unswizzle(img[s * 64 * fp.W: (s + 1) * 64 * fp.W])
                          for s in range(n_slabs)])
    np.testing.assert_array_equal(got, stacked)
    # slab by slab: W_0's two, then four of each W_i, in the products' order
    rows = 0
    for i, w in enumerate(ops.ws):
        np.testing.assert_array_equal(got[rows: rows + w.shape[0]],
                                      w.to(torch.bfloat16).view(torch.int16).numpy(),
                                      err_msg=f"W_{i}")
        rows += w.shape[0]


@pytest.mark.parametrize("n_layers", [1, 2, 8, 16])
def test_slab_count_and_size(n_layers):
    _, ops = fp.probe_inputs(n_layers, n=1, device="cpu")
    img = fp.probe_weight_image_plain(ops.wbuf, n_layers)
    assert img.dtype == torch.bfloat16 and img.shape == ops.wbuf.shape
    assert img.numel() * 2 == (2 + 4 * (n_layers - 1)) * SLAB_BYTES


def test_tiles_match_the_kernels_dispatch():
    with open(SOURCE) as f:
        src = f.read()
    dispatch = re.search(r"int by_tile\(.*?\n}\n", src, re.S).group(0)
    cases = re.findall(r"case (\d+): return launch<V, (\d+)>", dispatch)
    assert all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == fp.TILES == (64, 128)
    # the ring stage is one K-slab of the image
    assert re.search(r"constexpr int STAGE_BYTES = 64 \* W \* 2;", src)


def test_cpu_operands_need_no_image(monkeypatch):
    """CPU operands carry no weight image, and the wrapper hands CPU
    tensors to the plain version and returns its result itself (held by
    identity through a spy, not by computing the plain version a second
    time: two fp32 matmul runs need not agree to the bit)."""
    in8, ops = fp.probe_inputs(3, n=200, bias_scale=0.1, device="cpu")
    assert ops.wimg is None
    plain, calls = fp.fwd_probe_plain, []

    def spy(*args):
        calls.append((args, plain(*args)))
        return calls[-1][1]

    monkeypatch.setattr(fp, "fwd_probe_plain", spy)
    before = fp.fwd_probe.launches
    for variant in fp.VARIANTS:
        got = fp.fwd_probe(in8, ops, variant, 128, torch.float32)
        (a_in8, a_ops, a_variant, a_dtype), out = calls[-1]
        assert got is out and a_in8 is in8 and a_ops is ops
        assert (a_variant, a_dtype) == (variant, torch.float32)
        assert got.dtype == torch.float32 and got.shape == (200, fp.OUT_W)
    assert len(calls) == len(fp.VARIANTS)
    assert fp.fwd_probe.launches == before  # the plain version counts no launch


def test_image_wrapper_takes_the_plain_version_on_the_cpu():
    _, ops = fp.probe_inputs(4, n=1, seed=3, device="cpu")
    before = fp.fwd_probe_image.launches
    assert torch.equal(fp.fwd_probe_image(ops.wbuf, 4), fp.probe_weight_image_plain(ops.wbuf, 4))
    assert fp.fwd_probe_image.launches == before
    with pytest.raises(ValueError, match="weights"):
        fp.fwd_probe_image(ops.wbuf, 3)
    with pytest.raises(ValueError, match="weights"):
        fp.fwd_probe_image(ops.wbuf.float(), 4)
