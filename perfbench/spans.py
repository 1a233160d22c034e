"""The program's own spans and counters, as the per-layer readers take
them: the port's recorder (``intrinsicnerf_tpu_torch/utils/trace.py``),
read once the run is over.  Its spans are on while ``torch.profiler``
records, so in a ``--trace 1`` run they hold the profiled sub-window;
its counters are always on.  A program without the recorder reads as
None, and so does a name the recorder holds no sample of.
"""

from __future__ import annotations


def snapshot():
    """The recorder's snapshot, or None where the program has none."""
    try:
        from intrinsicnerf_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def device_ms(name: str):
    """Device milliseconds per interval of span ``name`` (per step, for
    a step's phase), or None."""
    snap = snapshot()
    span = (snap or {}).get("spans", {}).get(name)
    if not span or not span.get("device_n"):
        return None
    return 1e3 * span["device_s"] / span["device_n"]


def intervals(name: str) -> list:
    """The device intervals ``(id, start s, end s)`` of span ``name``
    the recorder kept, oldest first; empty where there are none."""
    snap = snapshot()
    span = (snap or {}).get("spans", {}).get(name)
    return list(span.get("intervals_s", ())) if span else []


def ratio(num: str, den: str):
    """Counter ``num`` over counter ``den``, or None."""
    snap = snapshot()
    counters = (snap or {}).get("counters", {})
    if not counters.get(den):
        return None
    return counters.get(num, 0) / counters[den]
