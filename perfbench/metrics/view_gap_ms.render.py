"""Device milliseconds per view between the views' render work: over the
newest pass of ``render_views`` the profiler recorded (its views from
index 0), the device time from the first ``render.view`` span's start
stamp to the last ``render.to_host`` span's end stamp, less the
``render.view`` spans' own device time, over the views
(``perfbench/spans.py``).  It holds each view's copies to the host and
the time the device waits on the host between two views' render work
(the copies' host side, the finite checks).  A ``render.view`` span
starts when the host starts to enqueue the view, so the device's idle
while the host enqueues a view's first kernels lies inside that span,
not here: this is the part of the per-view bubble that lies outside the
enqueue windows."""

from perfbench import spans

LAYER = "render/pipeline.py"
UNIT = "ms"
MOVES = "view_ms"
KERNELS = ()


def read(run):
    if run.kind != "render":
        return None
    views = spans.intervals("render.view")
    starts = [i for i, (view, _, _) in enumerate(views) if view == 0]
    if not starts:
        return None
    views = views[starts[-1]:]
    t0 = views[0][1]
    ends = [t1 for _, s, t1 in spans.intervals("render.to_host") if s >= t0]
    if not ends:
        return None
    kernels = sum(t1 - s for _, s, t1 in views)
    return 1e3 * (max(ends) - t0 - kernels) / len(views)
