"""Kernel 1's persistent schedule and the counters that report it.

Kernel 1 (``ops/csrc/fused_mlp_fwd.cu``) launches min(tiles, SMs) blocks,
each walking its 64-point tiles in turn while its PE warps encode the
next; ``fused_mlp.fwd_schedule`` gives (blocks, tiles, tiles ahead) for a
call, and the wrapper adds the last two to the counters ``fwd.tiles`` and
``fwd.tiles_ahead``.  A count made while a training block is captured as
a CUDA graph belongs to the block and is added at each replay
(``utils/trace.py``).  The launch itself is held on the card
(``tests/test_torch_cuda.py``).
"""

import pytest

from intrinsicnerf_tpu_torch.ops import fused_mlp as fm
from intrinsicnerf_tpu_torch.utils import trace

H100_SMS = 132


@pytest.mark.parametrize("n,want", [
    (1, (1, 1, 0)),                   # one block with one tile: nothing ahead
    (8_448, (132, 132, 0)),           # one tile a block
    (8_449, (132, 133, 1)),           # the first tile ahead
    (65_536, (132, 1_024, 892)),      # the training step's coarse call: 87%
    (6_291_456, (132, 98_304, 98_172)),  # the view's fine chunk: 99.9%
])
def test_schedule_at_132_sms(n, want):
    assert fm.fwd_schedule(n, H100_SMS) == want


def test_schedule_covers_every_point_once():
    for n in (1, 63, 64, 65, 4_097, 100_003):
        for sms in (1, 7, H100_SMS):
            blocks, tiles, ahead = fm.fwd_schedule(n, sms)
            assert (tiles - 1) * fm.FWD_TILE < n <= tiles * fm.FWD_TILE
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
    trace.count("fwd.tiles", 1_024)
    trace.count("fwd.tiles_ahead", 892)
    fresh_recorder.capture = None
    assert "fwd.tiles" not in trace.snapshot()["counters"]  # the capture ran nothing
    trace.count("fwd.tiles", 3)  # an eager launch
    trace.replayed(stamps)
    trace.replayed(stamps)
    counters = trace.snapshot()["counters"]
    assert counters["fwd.tiles"] == 3 + 2 * 1_024
    assert counters["fwd.tiles_ahead"] == 2 * 892
    assert stamps.counts == {"fwd.tiles": 1_024, "fwd.tiles_ahead": 892}
