"""What the drivers share: the golden check and freeing the program."""

from __future__ import annotations

import gc

import numpy as np
import torch


def golden_check(predict, config: dict) -> tuple:
    """The configuration's golden (the MicroFlow reference's output for an
    input of one value) through ``predict``: ``(name, value, limit, ok)``,
    the value being the largest absolute difference."""
    g = config["golden"]
    x = np.full((1, *config["input_shape"]), g["input_fill"], np.float32)
    got = predict(x).cpu().numpy().reshape(-1)
    diff = float(np.abs(got - np.asarray(g["output"], np.float32)).max())
    return ("golden_diff", diff, 0, diff == 0)


def release_program(cell, *names: str) -> None:
    """Drop the program's objects named ``names`` on ``cell`` and return
    their device memory, so that the reference runs beside only the
    outputs it judges."""
    for name in names:
        setattr(cell, name, None)
    gc.collect()
    if cell.ctx.device.type == "cuda":
        torch.cuda.synchronize(cell.ctx.device)
        torch.cuda.empty_cache()
