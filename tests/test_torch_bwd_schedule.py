"""Kernel 2's persistent activation pass and the counters that report it.

Kernel 2's activation pass (``ops/csrc/fused_mlp_bwd.cu``) launches
min(tiles, SMs) blocks, each walking its 64-point tiles in turn while its
staging warps stage the next tile's inputs; ``fused_mlp.bwd_schedule``
gives (blocks, tiles, tiles ahead) for a call, and the wrapper adds the
last two to the counters ``bwd.tiles`` and ``bwd.tiles_ahead``.  A count
made while a training block is captured as a CUDA graph belongs to the
block and is added at each replay (``utils/trace.py``).  The launch itself
is held on the card (``tests/test_torch_cuda.py``).

Kernel 2 reads the saved forward that kernel 1's training launch writes
(``fused_mlp.backward_scratch`` sizes it, and the kernel scratch beside
it); that launch counts its tiles in ``fwd.saved_tiles``.
"""

import pytest

from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.utils import trace

H100_SMS = 132


@pytest.mark.parametrize("n,want", [
    (1, (1, 1, 0)),                   # one block with one tile: nothing ahead
    (64, (1, 1, 0)),                  # exactly one tile
    (8_448, (132, 132, 0)),           # one tile a block
    (8_512, (132, 133, 1)),           # one block walks two tiles
    (65_536, (132, 1_024, 892)),      # Replica's coarse step call
    (196_608, (132, 3_072, 2_940)),   # Replica's fine step call: 95.7% ahead
    (131_072, (132, 2_048, 1_916)),   # fern's coarse step call
    (262_144, (132, 4_096, 3_964)),   # fern's fine step call: 96.8% ahead
])
def test_schedule_at_132_sms(n, want):
    assert fm.bwd_schedule(n, H100_SMS) == want


def test_schedule_covers_every_point_once():
    for n in (1, 63, 64, 65, 4_097, 100_003):
        for sms in (1, 7, H100_SMS):
            blocks, tiles, ahead = fm.bwd_schedule(n, sms)
            assert (tiles - 1) * 64 < n <= tiles * 64
            assert blocks == min(tiles, sms) and ahead == tiles - blocks >= 0


@pytest.fixture
def fresh_recorder():
    trace.reset()
    yield trace.RECORDER
    trace.RECORDER.capture = None
    trace.reset()


def test_counts_made_while_captured_count_at_each_replay(fresh_recorder):
    stamps = trace.Stamps()  # what trace.capturing() installs around a capture
    fresh_recorder.capture = stamps
    for n in (65_536, 196_608):  # one captured Replica step's two backward calls
        _, tiles, ahead = fm.bwd_schedule(n, H100_SMS)
        trace.count("bwd.tiles", tiles)
        trace.count("bwd.tiles_ahead", ahead)
    fresh_recorder.capture = None
    assert "bwd.tiles" not in trace.snapshot()["counters"]  # the capture ran nothing
    trace.count("bwd.tiles", 5)  # an eager launch
    trace.replayed(stamps)
    trace.replayed(stamps)
    counters = trace.snapshot()["counters"]
    assert counters["bwd.tiles"] == 5 + 2 * (1_024 + 3_072)
    assert counters["bwd.tiles_ahead"] == 2 * (892 + 2_940)
    assert stamps.counts == {"bwd.tiles": 4_096, "bwd.tiles_ahead": 3_832}


def test_counts_saved_tiles_at_each_replay_as_the_backward_tiles(fresh_recorder):
    # a captured Replica step: each level's saving forward counts its tiles
    # in fwd.saved_tiles, and its backward as many in bwd.tiles
    stamps = trace.Stamps()
    fresh_recorder.capture = stamps
    for n in (65_536, 196_608):
        _, tiles, _ = fm.fwd_schedule(n, H100_SMS)
        trace.count("fwd.saved_tiles", tiles)
        trace.count("bwd.tiles", fm.bwd_schedule(n, H100_SMS)[1])
    fresh_recorder.capture = None
    for _ in range(3):
        trace.replayed(stamps)
    counters = trace.snapshot()["counters"]
    assert counters["fwd.saved_tiles"] == counters["bwd.tiles"] == 3 * (1_024 + 3_072)


@pytest.mark.parametrize("n,tiles", [(1, 1), (64, 1), (4_097, 65), (196_608, 3_072)])
def test_scratch_sizes_follow_the_layout(n, tiles):
    # the saved forward: 2,944 bf16 a padded point (features 128, trunk
    # 8 x 256, a1, s1, m1 128 each, f 256, v 128), then 12 ReLU layers x 256
    # threads x 2 words a tile; the gradient arena: the cotangent 128, the
    # trunk 8 x 256, ga1, gs1, gm1, gv 128 each, gf 256, then the 50-slab
    # weight image of the backward's input products
    p_pad = 64 * tiles
    acts = (128 + 8 * 256 + 3 * 128 + 256 + 128) * p_pad
    masks = 12 * 256 * 2 * tiles
    # W^T slabs of w_r, w_a2, w_s2, w_m2 (128 x 128), wv_f, w_sig, w_a1, w_s1,
    # w_m1 (128 x 256) and w_f, w7..w1 (256 x 256)
    image = 4 * 128 * 128 + 5 * 128 * 256 + 8 * 256 * 256
    arena = (128 + 8 * 256 + 4 * 128 + 256) * p_pad + image
    for splits in (1, fm.backward_splits(n)):
        assert fm.backward_scratch(n, splits) == (acts, masks, arena, tiles * 2_944,
                                                  splits * 835_584)
    assert 2 * acts + 4 * masks == 6_272 * p_pad  # bytes a padded point
    assert image == 753_664 and acts == arena - image
