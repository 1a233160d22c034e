"""Device milliseconds per training step in the pose sampler's projection
to NDC (each ray shifted to the near plane and projected): the program's
``sample.ndc`` span inside ``step.sample``, timed by the device-clock
stamps at its bounds (in a captured block, those of the newest replay
made while the profiler recorded, over its steps) (``perfbench/spans.py``)."""

from perfbench import spans

LAYER = "data/samplers.py:gather_ray_pairs_from_poses"
UNIT = "ms"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms("sample.ndc")
