"""Offline scoring: ``CompiledModel.predict_inner`` on batches of int8 rows
already on the card, issued back to back by one caller.

Set-up builds the model through the program's default backend, checks the
bundled golden, draws a pool of ``pool_batches`` distinct batches from the
seed (larger than the card's 50 MB L2 together) and warms the one batch
shape.  The window cycles through the pool.  The caller keeps at most
``in_flight`` calls queued on the device, waiting on the event of the call
that many back, as a scoring loop bounds its memory; it never synchronises
the device inside the window.  The rate is every row completed over the
whole window, closed by one synchronise.

The check compares every output of the window with the configuration's
plain reference's output for its pool batch, element for element.
"""

from __future__ import annotations

import time

import torch

from ..traffic import int8_rows, torch_generator
from .common import golden_check, release_program


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from microflow_tpu_torch import compile_tflite

        ctx, p = self.ctx, self.ctx.params
        self.model = compile_tflite(ctx.model_file(), name=ctx.config["name"],
                                    device=ctx.device)
        if ctx.patch is not None:
            ctx.patch(self.model)
        ctx.phase("build")
        self.golden = golden_check(self.model.predict, ctx.config)
        ctx.phase("golden")
        gen = torch_generator(ctx.seed, ctx.device)
        shape = (p["pool_batches"], p["batch"], *self.model.graph.input_shape)
        self.pool = int8_rows(gen, shape, ctx.device)
        ctx.phase("inputs")
        for xq in self.pool[:1]:
            self.model.predict_inner(xq)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        ctx.phase("warm-up")
        self.ctx.counters["backend"] = self.model.backend

    def window(self, win) -> dict:
        model, pool, cuda = self.model, self.pool, self.ctx.device.type == "cuda"
        n_pool, ahead = pool.shape[0], self.ctx.params["in_flight"]
        outs, events, host_s = [], [], 0.0
        calls = traced = 0
        t0 = win.open()
        while True:
            a = time.perf_counter()
            y = model.predict_inner(pool[calls % n_pool])
            b = time.perf_counter()
            outs.append(y)
            if win.tracing:
                traced += 1
            else:
                host_s += b - a
            calls += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
                if len(events) > ahead:
                    events.pop(0).synchronize()
            if not win.running():
                break
        if cuda:
            torch.cuda.synchronize(self.ctx.device)
        elapsed = time.perf_counter() - t0
        self.outs = outs
        batch = pool.shape[1]
        self.attempted = calls * batch
        self.ctx.counters.update(calls=calls, calls_traced=traced, batch=batch,
                                 host_us_per_call=host_s * 1e6 / max(calls - traced, 1))
        return {"score_inferences_per_s": calls * batch / elapsed}

    def release(self) -> None:
        release_program(self, "model")

    def check(self) -> list:
        ctx = self.ctx
        ref = ctx.reference.Reference(ctx.model_file(), ctx.device)
        want = [ref.forward(xq) for xq in self.pool]
        if ctx.control:  # the control in the program's place
            ctl = ctx.reference.Reference(ctx.model_file(), ctx.device, int4=True)
            got_by_batch = [ctl.forward(xq) for xq in self.pool]
            self.outs = [got_by_batch[i % len(self.pool)] for i in range(len(self.outs))]
        wrong, worst = 0, 0
        n_pool = len(want)
        for i in range(n_pool):
            got = self.outs[i::n_pool]
            if not got:
                continue
            diff = (torch.stack(got).to(torch.int32) - want[i].to(torch.int32)[None]).abs()
            wrong += int((diff != 0).sum())
            worst = max(worst, int(diff.max()))
        return [self.golden,
                ("outputs_wrong", wrong, 0, wrong == 0),
                ("max_abs_diff", worst, 0, worst == 0)]

