"""Losses (port of ``intrinsicnerf_tpu/core/losses.py``).

Only what the eval-mode view renderer needs so far."""

from __future__ import annotations

import torch


def semantic_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-ray predictive entropy (uncertainty) over the class axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(-logp * torch.exp(logp), dim=-1)
