"""PyTorch/CUDA port of ``intrinsicnerf_tpu`` for NVIDIA Hopper (H100).

Module names mirror the JAX package so each counterpart is easy to find.
The package imports ``torch`` only: the JAX package is the reference the
tests hold it against, never a dependency.  Entry points that create
state default to ``device="cuda"`` and raise when no GPU is present
unless the caller asks for the CPU explicitly.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point creates its state on.

    ``"cuda"`` (the default everywhere) requires a visible GPU; there is
    no silent CPU fallback: pass ``device="cpu"`` to run on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "intrinsicnerf_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the host explicitly"
        )
    return dev
