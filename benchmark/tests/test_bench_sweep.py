"""``serve_sweep.py`` builds the harness's ``Context`` for the serve
driver: the sweep's context, with the card swapped for the CPU and the
traffic cut small, sets up the driver, serves one window and checks it."""

import sys

import torch

import benchmark.reference.model as frozen
from benchmark.drivers.serve import Cell
from benchmark.harness import Window

SMALL = {"rate_rps": 16, "max_rows": 40, "big_rows": 48, "big_every": 3, "pool_rows": 64,
         "submitters": 4, "check_requests": 8, "check_big": 2, "warm_s": 0.2}


def test_the_sweeps_context_sets_up_the_serve_driver(monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script sets sys.path[0]
    from benchmark.serve_sweep import sweep_context

    device, seed = torch.device("cpu"), 2**31 + 5
    ctx = sweep_context("person_detect.serve", seed, 0.4, device, SMALL)
    assert (ctx.cell, ctx.seed, ctx.device, ctx.seconds) == ("person_detect.serve", seed,
                                                             device, 0.4)
    assert ctx.config["name"] == "person_detect" and ctx.params["max_batch"] == 1024
    assert ctx.params["rate_rps"] == SMALL["rate_rps"] and ctx.reference is frozen
    cell = Cell(ctx)
    cell.setup()
    try:
        ctx.params["rate_rps"] = 24  # as the sweep sets each rate
        cell.plan(0.4)
        e2e = cell.window(Window(0.4, device, None))
    finally:
        cell.release()
    assert {"served_rows_per_s", "serve_p95_ms"} <= e2e.keys() and ctx.counters["rows"] > 0
    # every request the window sent was answered, and the sample checked is
    # the reference's, through the context's reference
    checks = cell.check()
    assert cell.failed == 0 and all(ok for _, _, _, ok in checks), checks
