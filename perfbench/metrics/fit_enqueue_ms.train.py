"""Host milliseconds per training step spent enqueueing it: the sum over
the window of ``Trainer.fit``'s ``step_hook`` gaps (host clock after a
call was enqueued less before it), over the steps."""

LAYER = "train/trainer.py:Trainer.fit"
UNIT = "ms"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 1e3 * run.enqueue_s / run.steps
