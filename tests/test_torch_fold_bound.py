"""The training fold's host bound (``TrainableModel._fold_bound``) holds only
for the accumulators it was set on.  An accumulator replaced inside
``model.grads`` or written in place has the bound read from the tensors at
the next step, so the conv/dw accumulators equal the serial saturating fold
(the reference's per-sample ``accumulate_gradient_4D``,
``update_layer.rs:273-294``) bit for bit.  Held against the port's own
serial fold (``optimizer.accumulate_gradient_4d_fold`` with ``bound=None``):
the JAX trainer keeps a stale bound after such an edit as well.

The case: person_detect's ten trained layers at batch 32; after one step the
bound is 4096; layer 26's accumulator (65,536 entries) then holds
-2**31 + 10 in every entry.  With the stale bound the fold wraps (28,100
entries came out positive through ``fill_``); the serial fold clamps, and
none is positive."""

import pytest
import torch

from microflow_tpu_torch.models import person_detect_trainable
from microflow_tpu_torch.train import optimizer
from microflow_tpu_torch.train import trainer as ttrainer

LAYER = "layer26"
EDGE = -2**31 + 10
BATCH = 32


def batch(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (BATCH, 96, 96, 1), generator=gen, dtype=torch.int8)
    gt = torch.randint(-128, 128, (BATCH, 2), generator=gen, dtype=torch.int8)
    return x, gt


def edit(model, how: str) -> None:
    grads = model.grads
    acc = grads[LAYER]["weights_gradient"]
    if how == "fill_":
        acc.fill_(EDGE)
    elif how == "nested":
        grads[LAYER]["weights_gradient"] = torch.full_like(acc, EDGE)
    else:  # the whole dict, through the setter
        model.grads = {k: {kk: (torch.full_like(v, EDGE) if (k, kk) == (LAYER, "weights_gradient")
                                else v.clone()) for kk, v in d.items()}
                       for k, d in grads.items()}


def run(how: str, monkeypatch=None) -> dict:
    """Two steps with ``how``'s edit between them; with ``monkeypatch``, every
    fold is the serial one (its bound read from the tensor)."""
    if monkeypatch is not None:
        fold = optimizer.accumulate_gradient_4d_fold
        monkeypatch.setattr(ttrainer.optimizer, "accumulate_gradient_4d_fold",
                            lambda dW_b, acc, bound=None: fold(dW_b, acc, None))
    m = person_detect_trainable(10, backend="xla", device="cpu")
    x, gt = batch()
    m.predict_quantized_train(x, gt)
    assert m._fold_bound == 128 * BATCH
    edit(m, how)
    m.predict_quantized_train(x, gt)
    return m.grads


@pytest.mark.parametrize("how", ["fill_", "nested", "setter"])
def test_an_edited_accumulator_gets_the_serial_fold(how, monkeypatch):
    got = run(how)
    acc = got[LAYER]["weights_gradient"]
    assert acc.numel() == 65536
    assert int((acc > 0).sum()) == 0 and int(acc.max()) < EDGE + 128 * BATCH
    with monkeypatch.context() as mp:
        want = run(how, mp)
    for layer, arrays in want.items():
        for k, v in arrays.items():
            assert torch.equal(got[layer][k], v), (layer, k)


def test_a_training_loop_reads_no_bound_from_the_tensors(monkeypatch):
    """Steps and updates keep the bound on the host: no device read, until
    an accumulator is written from outside; then exactly one."""
    m = person_detect_trainable(10, backend="xla", device="cpu")
    reads = []
    read = m._accumulator_bound
    monkeypatch.setattr(m, "_accumulator_bound", lambda: reads.append(1) or read())
    x, gt = batch()
    x, gt = x[:4], gt[:4]
    for _ in range(2):
        m.predict_quantized_train(x, gt)
        m.predict_quantized_train(x, gt)
        m.update_layers(4, 0.01)
    m.predict_quantized_train(x, gt)
    assert reads == [] and m._fold_bound == 128 * 4
    m.grads["layer21"]["weights_gradient"].add_(1)
    m.predict_quantized_train(x, gt)
    m.predict_quantized_train(x, gt)
    assert len(reads) == 1
