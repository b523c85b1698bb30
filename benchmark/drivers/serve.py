"""Online serving: ``BatchServer`` on the one card under an open loop.

Set-up builds the model through the program's default backend, checks the
golden, starts the server (``max_batch``, ``max_wait_ms``), warms every
bucket it can dispatch, and makes three pools of inputs from the seed: f32
rows in pageable host memory (for ``submit``), int8 rows in pageable host
memory and int8 rows on the card (for ``submit_quantized``).

The window follows ``traffic.request_schedule``: a scheduler thread sleeps
until each request is due and hands it to a pool of ``submitters``
threads, which submit it and stamp its completion by a callback on its
future.  A request's latency runs from its due time to its rows on the
host, so a late generator or a stalled submitter counts against it.  The
window ends with the schedule; then every request is waited for, up to
``wait_s`` past the close.  A request that fails, or never completes,
counts as missing every limit.

The check runs the plain reference over a sample of the requests drawn
from the seed, the longest among them, and compares each row the server
returned, exactly.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..traffic import int8_rows, nearest_rank, numpy_rng, request_schedule, torch_generator
from ..harness import Window
from .common import golden_check, release_program


def buckets(max_batch: int) -> list[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0
        self.server = self.executor = None

    def setup(self) -> None:
        from microflow_tpu_torch import compile_tflite
        from microflow_tpu_torch.parallel import BatchServer

        ctx, p = self.ctx, self.ctx.params
        model = compile_tflite(ctx.model_file(), name=ctx.config["name"], device=ctx.device)
        if ctx.patch is not None:
            ctx.patch(model)
        ctx.phase("build")
        self.golden = golden_check(model.predict, ctx.config)
        ctx.phase("golden")
        self.server = BatchServer(model, max_batch=p["max_batch"],
                                  max_wait_ms=p["max_wait_ms"])
        for b in buckets(p["max_batch"]):
            self.server.warm(b)
        ctx.phase("buckets")
        gen = torch_generator(ctx.seed, ctx.device)
        shape = (p["pool_rows"], *model.graph.input_shape)
        self.pools = {
            "f32": torch.rand(shape, generator=gen, device=ctx.device).cpu().numpy(),
            "int8_host": int8_rows(gen, shape, ctx.device).cpu().numpy(),
            "int8_device": int8_rows(gen, shape, ctx.device),
        }
        ctx.phase("inputs")
        self.executor = ThreadPoolExecutor(max_workers=p["submitters"])
        # every submitter thread started, and each kind's submit path run once
        ready = threading.Barrier(p["submitters"] + 1)
        for _ in range(p["submitters"]):
            self.executor.submit(ready.wait)
        ready.wait()
        for kind in p["kinds"]:  # each kind's submit path at the smallest and largest size
            for rows in (1, p["big_rows"]):
                self._submit(kind, 0, rows).result(timeout=60)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        ctx.counters["backend"] = model.backend
        # the mix itself for ``warm_s``: the allocator's blocks for the
        # coalesced sizes, the copies' staging, the worker's first batches
        self.sched = request_schedule(p, p["warm_s"], ctx.seed, p["pool_rows"], stream=3)
        self.checked, self.planned = [], None
        ctx.phase("submit paths")
        self.window(Window(p["warm_s"], ctx.device, None), label="serve warm-up")
        self.plan(ctx.seconds)
        ctx.phase("mix warm-up")

    def _submit(self, kind: str, offset: int, rows: int):
        x = self.pools[kind][offset:offset + rows]
        if kind == "f32":
            return self.server.submit(x)
        return self.server.submit_quantized(x)

    def plan(self, seconds: float) -> None:
        """The window's schedule and the requests the check will read (up
        to ``check_big`` of the longest and ``check_requests`` others, drawn
        from the seed), made before the window so that the window keeps
        the results of those alone."""
        p = self.ctx.params
        self.sched = request_schedule(p, seconds, self.ctx.seed, p["pool_rows"])
        rng = numpy_rng(self.ctx.seed, 2)
        rows = self.sched["rows"]
        big = np.flatnonzero(rows == p["big_rows"])
        rest = np.flatnonzero(rows != p["big_rows"])
        pick = [rng.choice(ids, min(k, len(ids)), replace=False)
                for ids, k in ((big, p["check_big"]), (rest, p["check_requests"]))]
        self.checked = sorted(int(i) for i in np.concatenate(pick))
        self.planned = (p["rate_rps"], seconds)

    def window(self, win, label: str = "serve") -> dict:
        p = self.ctx.params
        if self.planned not in (None, (p["rate_rps"], win.seconds)):
            self.plan(win.seconds)
        sched, kinds = self.sched, p["kinds"]
        due, rows, kind, offset = (sched[k] for k in ("due", "rows", "kind", "offset"))
        n = len(due)
        handed = np.zeros(n)
        done = np.full(n, np.nan)
        keep = set(self.checked)
        futs: dict = {}
        errors: list = []
        all_done = threading.Event()
        lock = threading.Lock()
        left = [n]

        def finish(i, failed: bool):
            done[i] = time.perf_counter()
            if failed:
                errors.append(i)
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()

        def deliver(i):
            try:
                fut = self._submit(kinds[kind[i]], int(offset[i]), int(rows[i]))
            except Exception as e:  # a refused submission is a failed request
                print(f"serve: request {i} refused: {e!r}", file=sys.stderr)
                finish(i, True)
                return
            if i in keep:
                futs[i] = fut
            fut.add_done_callback(lambda f: finish(i, f.exception() is not None))

        stats0 = self.server.stats()
        t0 = win.open()
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            win.running()
            handed[i] = time.perf_counter()
            self.executor.submit(deliver, i)
        t_end = t0 + win.seconds
        pause = t_end - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        stats_end = self.server.stats()
        backlog_rows = int(rows[~(done <= t_end)].sum())
        cap = t_end + p["wait_s"]
        all_done.wait(timeout=max(cap - time.perf_counter(), 0.0))
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        stats1 = self.server.stats()
        missing = np.isnan(done)
        latency = np.where(missing, cap, done) - (t0 + due)
        late = handed - (t0 + due)
        failed = set(errors) | set(np.flatnonzero(missing).tolist())
        self.futs, self.failed_ids = futs, failed
        self.attempted, self.failed = n, len(failed)
        delta = {k: stats1[k] - stats0[k] for k in stats0 if k != "queue_depth"}
        c = self.ctx.counters
        c.update(requests=n, rows=int(rows.sum()), stats_window=delta,
                 queue_depth_end=stats_end["queue_depth"], backlog_rows_end=backlog_rows,
                 drain_s=float(np.nanmax(done) - t_end) if not missing.all() else None,
                 late_p50_ms=1e3 * float(np.median(late)),
                 late_p99_ms=1e3 * nearest_rank(late, 0.99),
                 late_max_ms=1e3 * float(late.max()))
        print(f"{label}: {n} requests, {c['rows']} rows in {win.seconds} s; generator late "
              f"p50 {c['late_p50_ms']:.3f} ms, p99 {c['late_p99_ms']:.3f} ms, max "
              f"{c['late_max_ms']:.3f} ms; at the close {backlog_rows} rows not done, queue "
              f"depth {stats_end['queue_depth']}; drain {c['drain_s']} s; failed {len(failed)}",
              flush=True)
        return {"serve_p50_ms": 1e3 * nearest_rank(latency, 0.50),
                "serve_p95_ms": 1e3 * nearest_rank(latency, 0.95),
                "served_rows_per_s": (c["rows"] - backlog_rows) / win.seconds}

    def release(self) -> None:
        if self.server is not None:
            self.server.stop()
        if self.executor is not None:
            self.executor.shutdown(wait=True)
        self.executor = None
        release_program(self, "server")

    def check(self) -> list:
        ctx = self.ctx
        ref = ctx.reference.Reference(ctx.model_file(), ctx.device)
        ctl = (ctx.reference.Reference(ctx.model_file(), ctx.device, int4=True) if ctx.control
               else None)
        wrong_rows, worst, rows = 0, 0.0, 0
        kinds, sched = ctx.params["kinds"], self.sched
        for i in self.checked:
            if i in self.failed_ids:  # counted by requests_failed
                continue
            kind, offset = kinds[sched["kind"][i]], int(sched["offset"][i])
            x = self.pools[kind][offset:offset + int(sched["rows"][i])]
            xq = ref.quantize(x) if kind == "f32" else torch.as_tensor(x)
            want = ref.dequantize(ref.forward(xq)).cpu()
            if ctl is None:
                got = self.futs[i].result()
            else:  # the control in the program's place
                got = ctl.dequantize(ctl.forward(xq)).cpu()
            rows += want.shape[0]
            if got.shape != want.shape:  # rows missing or extra: all of them wrong
                wrong_rows += want.shape[0]
                continue
            diff = (got - want).abs().reshape(want.shape[0], -1)
            wrong_rows += int((diff.amax(dim=1) != 0).sum())
            worst = max(worst, float(diff.max()))
        ctx.counters["rows_checked"] = rows
        return [self.golden,
                ("requests_failed", self.failed, 0, self.failed == 0),
                ("rows_wrong", wrong_rows, 0, wrong_rows == 0),
                ("max_abs_diff", worst, 0, worst == 0)]
