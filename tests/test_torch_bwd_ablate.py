"""``tools/bwd_ablate.py``'s text patches against kernel 2's source.

The ablation tool cuts one part of the activation pass at a time by
replacing an anchor of ``ops/csrc/fused_mlp_bwd.cu`` in a copy of it.  An
edit of the source that moves or drops an anchor would break the tool only
on the card, where it builds the copies; so every variant's anchors are
held here against the source as it stands.
"""

import pytest

from intrinsicnerf_tpu_torch.tools import bwd_ablate


def _source() -> str:
    with open(bwd_ablate.SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("variant", sorted(bwd_ablate.PATCHES))
def test_patches_apply_to_the_source(variant):
    src = _source()
    for old, _ in bwd_ablate.PATCHES[variant]:
        assert src.count(old) == 1, f"{variant}: anchor {old[:50]!r}"
    patched = bwd_ablate.patched_source(variant)
    assert (patched == src) == (variant == "base")


def test_no_arena_stores_cuts_the_only_arena_store():
    # the arena has two writers, each through one helper that the variant's
    # anchors open: the consumers' one bulk store (store_atoms) and the
    # staging warps' one 16-byte store (stage_put, called for the cotangent)
    src = _source()
    (old, new), (old_put, new_put) = bwd_ablate.PATCHES["no_arena_stores"]
    assert src.count("hmma::bulk_store(") == 1
    helper = src.index("void store_atoms(")
    assert helper < src.index(old) < src.index("hmma::bulk_store(")
    assert "bulk_store" not in src[helper:src.index(old)]
    assert src.count("stage_put(") == 2
    put = src.index("void stage_put(")
    assert src.index(old_put) == src.index("{\n", put) + 2
    assert new.startswith("  return;\n") and new_put.startswith("  return;\n")


def test_staging_serial_releases_the_cotangent_at_the_tile_end():
    # the consumers' release of a tile's cotangent moves from its dH product
    # to the end of the tile, and the staging warps stage the next tile
    # after waiting for it, just before its cotangent's copy
    patched = bwd_ablate.patched_source("staging_serial")
    release = "release(go_empty);"
    assert patched.count(release) == 1
    assert patched.index("other = read;") < patched.index(release)
    wait = patched.index("hmma::mbar_wait(go_empty, j & 1);")
    assert wait < patched.index("if (next < tiles) stage_tile(") < patched.index(
        "if (pt == 0 && next < tiles)")


def test_no_mask_loads_sets_every_bit_and_loads_nothing():
    # the cut returns from load_mask with every mask bit set, before its
    # loads of the saved mask words; the 12 ReLU layers' epilogues still
    # take their words from load_mask (v, a1, s1, m1, act7, and the trunk
    # loop's act6..act0)
    src = _source()
    assert src.count("load_mask<") == 6
    patched = bwd_ablate.patched_source("no_mask_loads")
    body = patched[patched.index("void load_mask("):]
    body = body[:body.index("\n}\n")]
    assert body.index("bits[q] = 0xFFFFFFFFu;") < body.index("return;") < body.index("__ldcs(")
