"""``tools/fwd_ablate.py``'s text patches against kernel 1's source.

The ablation tool cuts one part of the forward at a time by replacing an
anchor of ``ops/csrc/fused_mlp_fwd.cu`` in a copy of it.  An edit of the
source that moves or drops an anchor would break the tool only on the
card, where it builds the copies; so every variant's anchors are held
here against the source as it stands.
"""

import pytest

from intrinsicnerf_tpu_torch.tools import bwd_ablate, fwd_ablate


def _source() -> str:
    with open(fwd_ablate.SOURCE) as f:
        return f.read()


def _patched(variant: str) -> str:
    return bwd_ablate.patched_source(variant, fwd_ablate.SOURCE, fwd_ablate.PATCHES)


def _body(src: str, signature: str) -> str:
    """The text of the function that ``signature`` opens, to its closing
    brace at the start of a line."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("variant", sorted(fwd_ablate.PATCHES))
def test_patches_apply_to_the_source(variant):
    src = _source()
    for old, _ in fwd_ablate.PATCHES[variant]:
        assert src.count(old) == 1, f"{variant}: anchor {old[:50]!r}"
    assert (_patched(variant) == src) == (variant == "base")


def test_no_pe_cuts_the_arithmetic_and_keeps_the_arrival():
    # the cut returns from compute_feat; encode, its caller, still fences
    # and arrives on the buffer's full barrier, so the consumers never wait
    # forever
    (old, new), = fwd_ablate.PATCHES["no_pe"]
    assert new == "  return;\n" + old
    patched = _patched("no_pe")
    feat = _body(patched, "void compute_feat(")
    assert "  return;\n" + old in feat and "mbar_arrive" not in feat
    encode = _body(patched, "void encode(")
    call = encode.index("compute_feat(")
    assert encode.index("hmma::mbar_arrive(feat_full + buf * 8);") > call


def test_pe_serial_waits_for_the_tile_before():
    # the PE warps' only wait on a feature buffer's release moves from tile
    # j - 2 (the buffer's own last tile) to tile j - 1 (the other buffer)
    base = _body(_source(), "void encode(")
    serial = _body(_patched("pe_serial"), "void encode(")
    assert base.count("mbar_wait(feat_empty") == serial.count("mbar_wait(feat_empty") == 1
    assert "(buf ^ 1) * 8, ((j - 1) >> 1) & 1)" in serial

