"""Blocking device-to-host copies per view: the program's counters
``render.host_syncs`` over ``render.views`` (``perfbench/spans.py``)."""

from perfbench import spans

LAYER = "render/pipeline.py"
UNIT = "syncs/view"
MOVES = "view_ms"
KERNELS = ()


def read(run):
    if run.kind != "render":
        return None
    return spans.ratio("render.host_syncs", "render.views")
