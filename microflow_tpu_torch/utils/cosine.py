"""Cosine similarity accuracy helper (reference R12,
``src/cosine_distance.rs:5-33``), batched over the leading dim."""

from __future__ import annotations

import torch


def cosine_similarity(a, b) -> torch.Tensor:
    """f32 cosine similarity of two equally-shaped buffers, flattened per
    leading-dim element."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    num = (a * b).sum(dim=1)
    den = torch.sqrt((a * a).sum(dim=1)) * torch.sqrt((b * b).sum(dim=1))
    return num / den
