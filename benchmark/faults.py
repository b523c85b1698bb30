"""Faults planted in the program under a run, to show that the check that
decides ``correct`` catches each one the cells can have: ``FAULTS[cell
driver][name]`` is a patch, called with the program after set-up.  The
benchmark's own runs never plant one; ``control.py --fault`` does on the
card, ``tests/test_bench_faults.py`` on the CPU.  With one chip, no cell
has an exchange between chips to leave out.
"""

from __future__ import annotations

import torch


def _altered(y: torch.Tensor) -> torch.Tensor:
    """``y`` with its first element moved by one step of its type."""
    y = y.clone()
    flat = y.view(-1)
    flat[0] = flat[0] - 1 if flat[0] > 0 else flat[0] + 1
    return y


def _half_batch(fn):
    """``fn`` run on the first half of the rows, its rows repeated for the rest."""
    def call(x):
        n = x.shape[0]
        y = fn(x[:max(n // 2, 1)])
        return torch.cat([y, y])[:n]
    return call


def _rows(method: str, wrap):
    """Break ``method`` of the program for batches of more than one row (the
    golden's one row stays right, so the window's check is what fails)."""
    def patch(model):
        orig = getattr(model, method)
        broken = wrap(orig)
        setattr(model, method, lambda x: broken(x) if x.shape[0] > 1 else orig(x))
    return patch


def _answer_altered(f):
    return lambda x: _altered(f(x))


def _unchanged(model):
    """A step that leaves the state as it was: the update does nothing."""
    model.update_layers = lambda batch_size, lr: None


def _train_half_batch(model):
    """The step on half of the batch, the mean taken over that half."""
    step, update = model.predict_quantized_train, model.update_layers
    model.predict_quantized_train = lambda xq, gt, lr=0.0: step(
        xq[:xq.shape[0] // 2], gt[:gt.shape[0] // 2], lr)
    model.update_layers = lambda batch_size, lr: update(batch_size // 2, lr)


def _train_altered(model):
    """One gradient entry moved by one where the step produces it."""
    step = model.predict_quantized_train

    def broken(xq, gt, lr=0.0):
        out = step(xq, gt, lr)
        model.grads[sorted(model.grads)[-1]]["weights_gradient"].view(-1)[0] += 1
        return out
    model.predict_quantized_train = broken


FAULTS = {
    "score": {"answer_altered": _rows("predict_inner", _answer_altered),
              "half_batch": _rows("predict_inner", _half_batch)},
    "serve": {"answer_altered": _rows("predict_quantized", _answer_altered),
              "half_batch": _rows("predict_quantized", _half_batch)},
    "train": {"state_unchanged": _unchanged, "half_batch": _train_half_batch,
              "answer_altered": _train_altered},
}
