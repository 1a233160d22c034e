"""Spans and counters at the port's layer boundaries.

A span is a named host interval, kept in memory with the span it nests
in; while ``torch.profiler`` records, it is also entered as a
``torch.profiler.record_function`` annotation, so it lands in the
profiler's Chrome trace beside the kernels it launched.  Spans are on
only while the profiler records or inside :func:`recording`; off, a span
costs one flag check and records nothing.
A span made with ``always=True`` (a rebuild, a kernel build, or a caller
that needs its bounds) keeps its host interval even when off, and enters
the profiler only when on.

:func:`device_span` adds the device time of the work it encloses: a
one-thread kernel (``ops/csrc/clock_stamp.cu``) writes the device's
global timer (ns) into a stamp slot on the current stream at the span's
start and at its end.  Eager, a device span stamps only when on, into
the recorder's slots.  While a training block is captured as a CUDA
graph (:func:`capturing`) it stamps whether on or off, into slots the
graph owns: every replay rewrites them, and they are read
(:func:`replayed`) only for a replay made while spans are on.  Stamps are
read only when the recorder is read.

Counters (:func:`count`) are always on, and are placed only at boundaries
a call crosses anyway; a count made while a training block is captured
belongs to the block, and each of its replays adds it.  :func:`snapshot`
gives, per span name, its count, host seconds, self seconds (host time
less what its child spans cover), device seconds and the number of
device intervals behind them, with the newest device intervals
themselves (id, start, end: seconds on the device's clock), then the
counters, with the kernel wrappers' launch counters and the live graphed
blocks' replays read where they are kept.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref
from typing import Dict, List, Optional

import torch

BLOCK = 1024  # stamp slots a device block holds
INTERVALS = 4096  # newest device intervals kept per span name


def _stamp(ptr: int) -> None:
    """Enqueue a write of the device's global timer (ns) into the int64 at
    device address ``ptr`` (``ops/csrc/clock_stamp.cu``) on the current
    stream."""
    from intrinsicnerf_tpu_torch.ops.build import load_library

    err = load_library("clock_stamp").clock_stamp(ptr, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"clock_stamp launch failed: cudaError {err}")


_READY = set()  # devices the stamp kernel has run on


def ready() -> None:
    """Build and load the stamp kernel and run it once on the current
    device, so that the first device span that is on (say, in a profiled
    window) pays for neither; after that, a set lookup."""
    dev = torch.cuda.current_device()
    if dev not in _READY:
        warm = torch.empty(1, dtype=torch.int64, device=dev)
        _stamp(warm.data_ptr())
        _READY.add(dev)


class Stamps:
    """Device clock stamps and the device spans they bound: int64 slots
    on the device, in blocks of ``BLOCK``, and per span ``(name, id,
    start slot, end slot)``."""

    def __init__(self):
        self.blocks: List[torch.Tensor] = []
        self.n = 0
        self.spans: List[tuple] = []
        self.open: List = []  # ids of the captured spans open now, innermost last
        self.counts: Dict[str, int] = {}  # counts made in the capture: each replay adds them

    def stamp(self) -> int:
        """Stamp the next slot on the current stream; returns the slot."""
        j = self.n % BLOCK
        if j == 0:
            self.blocks.append(torch.empty(BLOCK, dtype=torch.int64,
                                           device=torch.cuda.current_device()))
        _stamp(self.blocks[-1].data_ptr() + 8 * j)
        self.n += 1
        return self.n - 1

    def intervals(self) -> List[tuple]:
        """``(name, id, start s, end s)`` of each span, waiting for the
        stamps."""
        if not self.spans:
            return []
        ns = torch.cat(self.blocks).tolist()
        return [(name, id, ns[a] * 1e-9, ns[b] * 1e-9) for name, id, a, b in self.spans]


class Span:
    """One open or closed span: its name, the request's id, the span it
    nests in, the host clock at its bounds (``perf_counter_ns``) and the
    host time its child spans cover."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "child_ns", "stamps", "slot", "_rf")

    def __init__(self, name: str, id, stamps: Optional[Stamps]):
        self.name, self.id, self.parent = name, id, None
        self.t0 = self.t1 = 0
        self.child_ns = 0
        self.stamps, self.slot = stamps, None
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class _Off:
    """The context of a span that is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _entry() -> dict:
    return {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0, "device_n": 0,
            "intervals_s": collections.deque(maxlen=INTERVALS)}


class Recorder:
    """Spans, device stamps and counters of one process (its main
    thread: no span or counter runs on another)."""

    def __init__(self):
        self.depth = 0  # open ``recording()`` contexts
        self.stack: List[Span] = []  # open spans
        self.capture: Optional[Stamps] = None  # the block being captured
        self.blocks = weakref.WeakSet()  # live graphed blocks (``make_multi_step``)
        self.reset()

    def reset(self) -> None:
        self.totals: Dict[str, dict] = collections.defaultdict(_entry)
        self.counters: Dict[str, int] = {}
        self.stamps = Stamps()  # eager device spans, unread
        self.replays: Dict[int, Stamps] = {}  # graphs replayed while on, unread

    def enter(self, s: Span, profile: bool) -> Span:
        if profile:
            s._rf = torch.profiler.record_function(s.name, None if s.id is None else str(s.id))
            s._rf.__enter__()
        s.parent = self.stack[-1] if self.stack else None
        self.stack.append(s)
        if s.stamps is not None:
            s.slot = s.stamps.stamp()
        s.t0 = time.perf_counter_ns()
        return s

    def exit(self, s: Span) -> None:
        s.t1 = time.perf_counter_ns()
        if s.stamps is not None:
            s.stamps.spans.append((s.name, s.id, s.slot, s.stamps.stamp()))
        if self.stack and self.stack[-1] is s:
            self.stack.pop()
        if s._rf is not None:
            s._rf.__exit__(None, None, None)
            s._rf = None
        took = s.t1 - s.t0
        if s.parent is not None:
            s.parent.child_ns += took
        e = self.totals[s.name]
        e["count"] += 1
        e["host_s"] += took * 1e-9
        e["self_s"] += (took - s.child_ns) * 1e-9

    def snapshot(self) -> dict:
        from intrinsicnerf_tpu_torch.ops import fused_mlp as fm

        unread = [self.stamps, *self.replays.values()]
        self.stamps, self.replays = Stamps(), {}
        for stamps in unread:
            for name, id, t0, t1 in stamps.intervals():
                e = self.totals[name]
                e["device_s"] += t1 - t0
                e["device_n"] += 1
                e["intervals_s"].append((id, t0, t1))
        spans = {name: {**e, "intervals_s": list(e["intervals_s"])}
                 for name, e in self.totals.items()}
        counters = dict(self.counters)
        blocks = list(self.blocks)
        counters["graph.replays"] = sum(b.replays for b in blocks)
        for name, c in fm.LAUNCH_COUNTERS.items():
            counters[f"launches.{name}"] = c.launches
            counters[f"graph.replayed.{name}"] = sum(b.replayed.get(name, 0) for b in blocks)
        return {"spans": spans, "counters": counters}


RECORDER = Recorder()


class _Timed:
    """The context of a span that is on, or kept always."""

    __slots__ = ("span", "profile")

    def __init__(self, name, id, profile: bool, stamps: Optional[Stamps] = None):
        self.span = Span(name, id, stamps)
        self.profile = profile

    def __enter__(self) -> Span:
        return RECORDER.enter(self.span, self.profile)

    def __exit__(self, *exc):
        RECORDER.exit(self.span)
        return False


class _Captured:
    """A device span inside a captured block: a stamp at each bound, into
    the block's slots, and no host interval."""

    __slots__ = ("name", "id", "stamps", "slot")

    def __init__(self, name, id, stamps: Stamps):
        self.name, self.id, self.stamps = name, id, stamps

    def __enter__(self):
        self.slot = self.stamps.stamp()
        self.stamps.open.append(self.id)
        return None

    def __exit__(self, *exc):
        self.stamps.open.pop()
        self.stamps.spans.append((self.name, self.id, self.slot, self.stamps.stamp()))
        return False


def enabled() -> bool:
    """Whether spans are on: ``torch.profiler`` records, or a
    :func:`recording` context is open."""
    return RECORDER.depth > 0 or torch._C._autograd._profiler_enabled()


def span(name: str, id=None, always: bool = False):
    """A context over a host interval ``name`` (``id``: the request it
    serves, such as the view index or the step count); yields its
    :class:`Span`, or None when off.  It enters the profiler only while
    the profiler records."""
    profiling = torch._C._autograd._profiler_enabled()
    if profiling or always or RECORDER.depth > 0:
        return _Timed(name, id, profiling)
    return _OFF


def device_span(name: str, id=None):
    """:func:`span` with the device time of the work it encloses: a clock
    stamp at each bound on the current stream, when on.  Inside a
    captured training block (see :func:`capturing`) it stamps into the
    block's slots whether on or off, and keeps no host interval.  Given
    no ``id``, it takes the id of the span it nests in."""
    capture = RECORDER.capture
    if capture is not None:
        return _Captured(name, capture.open[-1] if id is None and capture.open else id, capture)
    profiling = torch._C._autograd._profiler_enabled()
    if not (profiling or RECORDER.depth > 0):
        return _OFF
    if id is None and RECORDER.stack:
        id = RECORDER.stack[-1].id
    device = torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()
    return _Timed(name, id, profiling, RECORDER.stamps if device else None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on).  Inside a block being
    captured (:func:`capturing`) it adds ``n`` to the block's counts, which
    each replay of the block adds to the counter (:func:`replayed`)."""
    counts = RECORDER.counters if RECORDER.capture is None else RECORDER.capture.counts
    counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Spans on for the body, without a profiler: the in-memory
    :func:`snapshot` alone."""
    RECORDER.depth += 1
    try:
        yield RECORDER
    finally:
        RECORDER.depth -= 1


@contextlib.contextmanager
def capturing():
    """Device spans stamp into slots of their own in a block about to be
    captured as a CUDA graph (entered before the capture, which
    :func:`ready` readies the stamp's kernel for); yields those
    :class:`Stamps`."""
    ready()
    stamps = Stamps()
    RECORDER.capture = stamps
    try:
        yield stamps
    finally:
        RECORDER.capture = None


def replayed(stamps: Optional[Stamps]) -> None:
    """A graph holding ``stamps`` was replayed: its captured counts are
    counted again, and when on, its device spans are read (from its newest
    replay's stamps) at the next snapshot."""
    if stamps is None:
        return
    for name, n in stamps.counts.items():
        RECORDER.counters[name] = RECORDER.counters.get(name, 0) + n
    if stamps.spans and enabled():
        RECORDER.replays[id(stamps)] = stamps


def watch(block) -> None:
    """Read ``block``'s ``.replays`` and ``.replayed`` in snapshots while
    it lives."""
    RECORDER.blocks.add(block)


def snapshot() -> dict:
    """``{"spans": {name: {count, host_s, self_s, device_s, device_n,
    intervals_s}}, "counters": {name: n}}``.  Stamps are read here,
    waiting for the device where they are not written yet."""
    return RECORDER.snapshot()


def reset() -> None:
    """Clear spans, stamps and this module's counters (the launch
    counters and replays stay where they are kept)."""
    RECORDER.reset()
