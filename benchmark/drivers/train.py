"""Retraining: ``TrainableModel`` steps of ``predict_quantized_train`` then
``update_layers``, on batches of int8 inputs with one-hot int8 labels.

Set-up builds the trainer (the configuration's ``train`` block: layers,
loss, backend), checks the golden through it, draws a pool of
``pool_batches`` distinct batches and their labels from the seed, and
drives the first ``checked_steps`` steps through the window's own calls on
the first batches of the pool, keeping what the check needs: each step's
output, the gradient accumulators as the update gets them after the first
step, and the parameters after the last.  The same object then runs the
window, cycling through the pool, at most ``in_flight`` steps ahead of the
device.  The window's last step, issued once the window's time is up, is
checked too: the trained layers' weights and C0 before it, its output, the
accumulators it leaves and the parameters after its update.

The check replays the checked steps with the plain reference trainer and
compares, per leaf (each weight and folded-bias tensor of a trained
layer): each step's loss, the norm of the first gradient, and the norm of
the parameters' change after the checked steps, each as the gap between
the program's and the reference's over the larger of the reference's norm
of that leaf and of the median leaf; and every entry of that state
exactly.  Leaves whose reference gradient is under a thousandth of the
median leaf's (the conv biases, whose update the MicroFlow trainer
disables) are left out of the change.  The reference cannot replay the
hundreds of steps between: it takes up the program's weights and C0
before the window's last step (C2 it works out again), runs that step and
its update, and every entry of the output, accumulators and parameters
has to match.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..traffic import int8_rows, one_hot_int8, torch_generator
from .common import golden_check, release_program

LEAVES = ("weights", "c0")
GRAD_OF = {"weights": "weights_gradient", "c0": "c0_gradient"}


def _state(params: dict, layers, names=LEAVES) -> dict:
    """``{(layer, leaf): a copy}``; ``names=None`` takes every leaf."""
    return {(k, n): params[k][n].detach().clone() for k in layers
            for n in (params[k] if names is None else names)}


def _grads(grads: dict) -> dict:
    return {(k, n): grads[k][GRAD_OF[n]].detach().clone() for k in grads for n in LEAVES}


def _loss(out: torch.Tensor, cls: torch.Tensor) -> float:
    """Mean cross-entropy of the softmax of the loss layer's dequantized
    output against the labels' classes, in float64."""
    logp = torch.log_softmax(out.to(torch.float64).reshape(out.shape[0], -1), dim=1)
    cls = cls.reshape(-1, 1)[:logp.shape[0]].to(logp.device)
    return float(-logp.gather(1, cls).mean())


def _entries_wrong(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries that differ; all of them where the shapes differ."""
    if got.shape != want.shape:
        return want.numel()
    return int((got.to(torch.float64).cpu() != want.to(torch.float64).cpu()).sum())


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def _resume(ref, tr, state: dict, int4: bool = False) -> None:
    """Put the trainer ``tr`` of the reference module ``ref`` at ``state``,
    the program's weights and C0 of each trained layer (on the int4 grid
    for the control), and fold each FC layer's C2 again from its weights."""
    for (k, n), v in state.items():
        if int4 and n == "weights":
            v = torch.as_tensor(ref.to_int4_grid(v.cpu().numpy()))
        tr.params[k] = {**tr.params[k], n: v.to(tr.device, tr.params[k][n].dtype)}
    for layer in tr.layers:
        p = tr.params.get(f"layer{layer.index}", {})
        if "c2" in p:
            p["c2"] = ref.optimizer.update_constants_fully_connected(p["weights"],
                                                                     layer.in_q.zp0)


def _gap(got: dict, want: dict, keys) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and of the median leaf; where
    both are 0, the program's norm itself."""
    norms = {k: _norm(want[k]) for k in keys}
    median = float(np.median(list(norms.values()))) if norms else 0.0
    worst = 0.0
    for k in keys:
        gap = abs(_norm(got[k]) - norms[k])
        scale = max(norms[k], median)
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from microflow_tpu_torch.train.trainer import compile_tflite_train

        ctx, p, t = self.ctx, self.ctx.params, self.ctx.config["train"]
        self.model = compile_tflite_train(
            ctx.model_file(), t["num_train_layers"], t["loss"], t["skip_last_layer_train"],
            name=ctx.config["name"], backend=t["backend"], device=ctx.device)
        if ctx.patch is not None:
            ctx.patch(self.model)
        ctx.phase("build")
        self.golden = golden_check(self.model.predict, ctx.config)
        ctx.phase("golden")
        gen = torch_generator(ctx.seed, ctx.device)
        shape = (p["pool_batches"], p["batch"], *self.model.graph.input_shape)
        self.pool = int8_rows(gen, shape, ctx.device)
        self.labels, self.classes = one_hot_int8(gen, p["pool_batches"], p["batch"],
                                                 t["classes"], ctx.device)
        ctx.phase("inputs")
        layers = sorted(self.model.grads)
        self.layers = layers
        self.p0 = _state(self.model.params, layers)
        self.outs = []
        for step in range(p["checked_steps"]):
            self.outs.append(self.model.predict_quantized_train(
                self.pool[step], self.labels[step]).clone())
            if step == 0:
                self.g1 = _grads(self.model.grads)
            self.model.update_layers(p["batch"], p["lr"])
        self.p3 = _state(self.model.params, layers)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        ctx.phase("checked steps")
        ctx.counters["backend"] = self.model.backend

    def window(self, win) -> dict:
        model, p, cuda = self.model, self.ctx.params, self.ctx.device.type == "cuda"
        n_pool, batch, lr = p["pool_batches"], p["batch"], p["lr"]
        step, steps, traced, events, marks = p["checked_steps"], 0, 0, [], []
        last = False
        t0 = win.open()
        while not last:
            marks.append(time.perf_counter())
            last = not win.running()
            i = step % n_pool
            if last:
                self.last = {"batch": i, "before": _state(model.params, self.layers)}
            out = model.predict_quantized_train(self.pool[i], self.labels[i])
            if last:
                self.last.update(out=out.clone(), grads=_grads(model.grads))
            model.update_layers(batch, lr)
            if last:
                self.last["after"] = _state(model.params, self.layers, None)
            if win.tracing:
                traced += 1
            step += 1
            steps += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
                if len(events) > p["in_flight"]:
                    events.pop(0).synchronize()
        if cuda:
            torch.cuda.synchronize(self.ctx.device)
        elapsed = time.perf_counter() - t0
        self.attempted = steps * batch
        host_ms = np.diff(marks) * 1e3 if len(marks) > 1 else np.zeros(1)
        self.ctx.counters.update(steps=steps, steps_traced=traced, batch=batch)
        print(f"train: {steps} steps in {elapsed:.3f} s; host ms a step p10 "
              f"{np.percentile(host_ms, 10):.3f}, p50 {np.median(host_ms):.3f}, p90 "
              f"{np.percentile(host_ms, 90):.3f}, max {host_ms.max():.3f}", flush=True)
        return {"train_samples_per_s": steps * batch / elapsed}

    def release(self) -> None:
        release_program(self, "model")

    def check(self) -> list:
        ctx, p, t = self.ctx, self.ctx.params, self.ctx.config["train"]

        def trainer(int4: bool):
            return ctx.reference.Trainer(ctx.model_file(), ctx.device, t["num_train_layers"],
                                         t["loss"], t["skip_last_layer_train"], int4=int4)

        def replay(tr):
            p0 = _state(tr.params, self.layers)
            outs, g1 = [], None
            for step in range(p["checked_steps"]):
                outs.append(tr.step(self.pool[step], self.labels[step]))
                if step == 0:
                    g1 = _grads(tr.grads)
                tr.update(p["batch"], p["lr"])
            return p0, outs, g1, _state(tr.params, self.layers)

        def last_step(tr, int4: bool = False):
            _resume(ctx.reference, tr, self.last["before"], int4)
            i = self.last["batch"]
            out = tr.step(self.pool[i], self.labels[i])
            grads = _grads(tr.grads)
            tr.update(p["batch"], p["lr"])
            return out, grads, _state(tr.params, self.layers, None)

        ref = trainer(False)
        r0, r_outs, r_g1, r3 = replay(ref)
        r_last = last_step(ref)
        p0, outs, g1, p3 = self.p0, self.outs, self.g1, self.p3
        got_last = self.last["out"], self.last["grads"], self.last["after"]
        if ctx.control:  # the control in the program's place
            ctl = trainer(True)
            p0, outs, g1, p3 = replay(ctl)
            got_last = last_step(ctl, int4=True)
        losses = [(_loss(o, self.classes[s]), _loss(r, self.classes[s]))
                  for s, (o, r) in enumerate(zip(outs, r_outs))]
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in losses)
        grad_norms = {k: _norm(v) for k, v in r_g1.items()}
        median = float(np.median(list(grad_norms.values())))
        moved = [k for k in r_g1 if grad_norms[k] >= 1e-3 * median]
        grad_gap = _gap(g1, r_g1, list(r_g1))
        change = {k: p3[k].to(torch.float64) - p0[k].to(torch.float64) for k in moved}
        r_change = {k: r3[k].to(torch.float64) - r0[k].to(torch.float64) for k in moved}
        change_gap = _gap(change, r_change, moved)
        wrong = sum(_entries_wrong(g1[k], r_g1[k]) for k in r_g1)
        wrong += sum(_entries_wrong(p3[k], r3[k]) for k in r3)
        wrong += sum(_entries_wrong(o, r) for o, r in zip(outs, r_outs))
        (out, grads, after), (r_out, r_grads, r_after) = got_last, r_last
        last_wrong = _entries_wrong(out, r_out)
        last_wrong += sum(_entries_wrong(grads[k], r_grads[k]) for k in r_grads)
        last_wrong += sum(_entries_wrong(after[k], r_after[k]) if k in after
                          else r_after[k].numel() for k in r_after)
        ctx.counters.update(losses=losses, leaves_changed=len(moved), leaves=len(r_g1))
        return [self.golden,
                ("loss_gap", loss_gap, 0, loss_gap == 0),
                ("grad_gap", grad_gap, 0, grad_gap == 0),
                ("change_gap", change_gap, 0, change_gap == 0),
                ("state_entries_wrong", wrong, 0, wrong == 0),
                ("last_step_entries_wrong", last_wrong, 0, last_wrong == 0)]
