"""Kernel 2's persistent activation pass and the counters that report it.

Kernel 2's activation pass (``ops/csrc/fused_mlp_bwd.cu``) launches
min(tiles, SMs) blocks, each walking its 64-point tiles in turn while its
staging warps stage the next tile's inputs; ``fused_mlp.bwd_schedule``
gives (blocks, tiles, tiles ahead) for a call, and the wrapper adds the
last two to the counters ``bwd.tiles`` and ``bwd.tiles_ahead``.  A count
made while a training block is captured as a CUDA graph belongs to the
block and is added at each replay (``utils/trace.py``).  The launch itself
is held on the card (``tests/test_torch_cuda.py``).
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
