"""Reshape op (reference R11, ``src/ops/reshape.rs``) -- a pure row-major
NHWC relayout, batch-preserving."""

from __future__ import annotations

import torch


def reshape(x: torch.Tensor, target_shape: tuple) -> torch.Tensor:
    """``target_shape`` is the per-sample shape (without batch dim)."""
    return x.reshape(x.shape[0], *target_shape)
