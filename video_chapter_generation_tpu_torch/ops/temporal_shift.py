"""Temporal Shift Module: the plain oracle of the bottleneck kernels.

With channels split into n_div folds, fold 0 takes frame t + 1, fold 1
takes frame t - 1, the rest pass through; out-of-range frames are zero.
Frames are time-major within each clip (the `(b t)` flattening).
"""

from __future__ import annotations

import torch


def temporal_shift(x: torch.Tensor, n_segment: int,
                   n_div: int = 8) -> torch.Tensor:
    """x [N*T, H, W, C] (or [B, T, H, W, C]) -> same shape, shifted."""
    squeeze = x.dim() == 4
    if squeeze:
        x = x.reshape(x.shape[0] // n_segment, n_segment, *x.shape[1:])
    fold = x.shape[-1] // n_div
    out = torch.zeros_like(x)
    out[:, :-1, ..., :fold] = x[:, 1:, ..., :fold]
    out[:, 1:, ..., fold:2 * fold] = x[:, :-1, ..., fold:2 * fold]
    out[..., 2 * fold:] = x[..., 2 * fold:]
    if squeeze:
        out = out.reshape(-1, *out.shape[2:])
    return out
