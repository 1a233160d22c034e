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
    # the anchor opens the helper that issues the arena's one bulk store
    src = _source()
    (old, new), = bwd_ablate.PATCHES["no_arena_stores"]
    assert src.count("hmma::bulk_store(") == 1
    helper = src.index("void store_atoms(")
    assert helper < src.index(old) < src.index("hmma::bulk_store(")
    assert "bulk_store" not in src[helper:src.index(old)]
    assert new.startswith("  return;\n")
