"""Device milliseconds per training step in the step's backward phase
(``total.backward()`` with kernel 2, the gradient mask and any
all-reduce): the program's ``step.backward`` span, timed by the
device-clock stamps at the phase's bounds (in a captured block, those of
the newest replay made while the profiler recorded, over its steps)
(``perfbench/spans.py``)."""

from perfbench import spans

LAYER = "train/step.py"
UNIT = "ms"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms("step.backward")
