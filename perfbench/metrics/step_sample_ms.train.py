"""Device milliseconds per training step in the step's sampling phase (the
pair sampler, the noise draws and the loss weights): the program's
``step.sample`` span, timed by the device-clock stamps at the phase's
bounds (in a captured block, those of the newest replay made while the
profiler recorded, over its steps) (``perfbench/spans.py``)."""

from perfbench import spans

LAYER = "train/step.py"
UNIT = "ms"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms("step.sample")
