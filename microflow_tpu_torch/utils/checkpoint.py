"""Checkpoint / resume for trained parameters, in the JAX package's format
(``microflow_tpu.utils.checkpoint``): one ``.npz`` whose keys are the
nested dict's paths (``"layer21/weights"``).  The arrays are exact (int8,
int32, f32), so save -> load -> predict is bit-identical, and a file saved
by either package loads in the other."""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params(path: str, params: dict) -> None:
    """Write ``params`` (tensors on any device, or arrays) to ``path``
    (``np.savez``: ``.npz`` is appended when missing)."""
    np.savez(path, **_flatten(params))


def load_params(path: str, device=None) -> dict:
    """The params of a checkpoint as tensors on ``device`` (None means CUDA,
    which must be present)."""
    from ..compiler.builder import resolve_device

    device = resolve_device(device)
    with np.load(path) as data:
        flat = {k: torch.as_tensor(data[k], device=device) for k in data.files}
    return _unflatten(flat)
