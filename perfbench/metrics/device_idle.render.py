"""Share of the traced rendering sub-window in which no kernel, copy or
fill ran on the device: 1 - (union of busy intervals) / window."""

LAYER = "render/pipeline.py"
UNIT = "%"
MOVES = "view_ms"
KERNELS = ()


def read(run):
    s = run.summary
    if run.kind != "render" or s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
