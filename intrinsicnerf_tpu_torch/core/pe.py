"""Sinusoidal positional encoding (port of ``intrinsicnerf_tpu/core/pe.py``).

Reference ordering: ``[x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]``
with log-spaced frequencies ``2^0 .. 2^(num_freqs-1)`` and the input first
divided by ``scalar_factor`` (10 for Replica scene positions, 1 otherwise).
"""

from __future__ import annotations

import torch


def pe_output_dim(num_freqs: int, input_dim: int = 3, include_input: bool = True) -> int:
    return input_dim * (2 * num_freqs + (1 if include_input else 0))


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    scalar_factor: float = 1.0,
) -> torch.Tensor:
    """Encode ``x[..., D] -> [..., D*(1 + 2*num_freqs)]``."""
    if scalar_factor != 1.0:
        x = x / scalar_factor
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # [..., F, D]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, D]
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
