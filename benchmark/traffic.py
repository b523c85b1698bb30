"""The one traffic generator: inputs and request schedules from a
workload's parameters and the run's seed.

Inputs are made on the card by a ``torch.Generator`` seeded with the run's
seed, in a few large calls.  Request schedules are made on the host by a
numpy ``Generator`` of the same seed.  Every seed gets the same set of
request sizes and inter-arrival gaps, in another order, so that seeds
change the order of the work and not its amount.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def torch_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def numpy_rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


def int8_rows(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform int8 over [-128, 127]."""
    return torch.randint(-128, 128, tuple(shape), generator=gen, device=device,
                         dtype=torch.int8)


def one_hot_int8(gen: torch.Generator, batches: int, rows: int, classes: int, device):
    """Labels on the loss tensor's grid: 127 at a class drawn per row,
    -128 elsewhere.  Returns (labels [batches, rows, classes] int8,
    classes [batches, rows] int64)."""
    cls = torch.randint(0, classes, (batches, rows), generator=gen, device=device)
    gt = torch.full((batches, rows, classes), -128, dtype=torch.int8, device=device)
    gt.scatter_(2, cls[..., None], 127)
    return gt, cls


def request_schedule(p: dict, seconds: float, seed: int, pool_rows: int,
                     stream: int = 1) -> dict:
    """Requests due within ``seconds``: an open loop at ``p["rate_rps"]``
    with exponential gaps, sizes uniform over [``min_rows``, ``max_rows``]
    plus one request in ``big_every`` of ``big_rows``, kinds in equal
    shares of ``p["kinds"]``, each reading a slice of its kind's pool at an
    offset drawn from the seed.  Returns columns of numpy arrays (no
    object per request for the collector to scan): ``due`` (seconds from
    the window's start), ``rows``, ``kind`` (an index into ``p["kinds"]``)
    and ``offset``.  ``stream`` picks another order from the same seed (the
    warm-up's)."""
    n = max(1, round(p["rate_rps"] * seconds))
    rng = numpy_rng(seed, stream)
    # the same gaps for every seed (the quantiles of the exponential), in
    # the seed's order, scaled to end within the window
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    due = np.cumsum(gaps) - gaps[0]
    n_big = n // p["big_every"]
    span = p["max_rows"] - p["min_rows"] + 1
    small = p["min_rows"] + (np.arange(n - n_big) * span) // max(n - n_big, 1)
    rows = rng.permutation(np.concatenate([small, np.full(n_big, p["big_rows"])]))
    kind = rng.permutation(np.arange(n) % len(p["kinds"]))
    offset = rng.integers(0, pool_rows - rows + 1)
    return {"due": due, "rows": rows, "kind": kind, "offset": offset}


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least ``q`` of the values at or below it."""
    vals = sorted(values)
    return vals[max(0, math.ceil(q * len(vals)) - 1)]
