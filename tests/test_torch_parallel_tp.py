"""The port's tensor-parallel train step (``microflow_tpu_torch/parallel/
tp.py``: ``ShardedTrainer``) on meshes of CPU devices, against the port's
replicated ``TrainableModel`` and, for speech, the JAX package's
replicated step on the same numpy inputs (``tests/test_parallel.py:105-155``
holds the JAX GSPMD step to that same replicated step).

Every sum of the sharded step is of integers (or of float64 integers below
2**53), so the tolerance is none: outputs, grads and params bit-equal.  The
JAX update runs with jit disabled and the seeds are ones where the JAX
chain meets no FMA-contracted element (``tp.chain_sets``), as in
``tests/test_torch_trainer.py``.
"""

import jax
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu import models as jmodels
from microflow_tpu_torch import compile_tflite_train
from microflow_tpu_torch.models import model_path, person_detect_trainable, speech_trainable
from microflow_tpu_torch.parallel import Collectives, ShardedTrainer, make_mesh, shard_params
from microflow_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
B = 8
LR = 0.5


def cpu_mesh(n_data, n_model):
    return make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def np_tree(tree) -> dict:
    return {k: {n: np.asarray(v) for n, v in d.items()} for k, d in tree.items()}


def assert_tree(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k, d in want.items():
        assert got[k].keys() == d.keys(), (what, k)
        for n, v in d.items():
            g = np.asarray(got[k][n].cpu() if torch.is_tensor(got[k][n]) else got[k][n])
            assert g.dtype == v.dtype and g.tobytes() == np.asarray(v).tobytes(), (
                what, k, n, int((g != v).sum()))


def speech_inputs():
    """The JAX worker's batch (``scripts/multiprocess_worker.py:73-77``)."""
    rng = np.random.default_rng(0)
    xq = rng.integers(-128, 128, size=(B, 1960)).astype(np.int8)
    gt = np.full((B, 4), -128, np.int8)
    gt[:, 1] = 127
    return xq, gt


@pytest.fixture(scope="module")
def jax_speech():
    """The JAX replicated speech step and update on ``speech_inputs``."""
    jm = jmodels.speech_trainable()
    xq, gt = speech_inputs()
    assert tp.chain_sets(jm.graph, jm.params, xq)["fma"] == 0, "pick another seed"
    out = np.asarray(jm.predict_quantized_train(xq, gt, LR))
    grads = np_tree(jm.grads)
    with jax.disable_jit():
        jm.update_layers(B, LR)
    return {"out": out, "grads": grads, "params": np_tree(jm.params),
            "grads_after": np_tree(jm.grads)}


def run_pair(make, mesh, xq, gt, batch, steps=2, lr=LR, jax_ref=None):
    """``steps`` steps, an update and a step of a sharded and a replicated
    trainer of ``make()``; each output, the grads after each step and the
    params after the update bit-equal.  Returns the sharded trainer."""
    sharded, plain = ShardedTrainer(make(), mesh), make()
    for step in range(steps):
        out = sharded.predict_quantized_train(xq, gt)
        want = plain.predict_quantized_train(xq, gt)
        assert torch.equal(out, want), step
        params, grads = sharded.gather()
        assert_tree(grads, np_tree(plain.grads), f"grads after step {step}")
        if jax_ref is not None and step == 0:
            assert out.numpy().tobytes() == jax_ref["out"].tobytes()
            assert_tree(grads, jax_ref["grads"], "grads vs JAX")
            assert_tree(params, np_tree(plain.params), "params before the update")
            sharded.update_layers(batch, lr)
            plain.update_layers(batch, lr)
            params, grads = sharded.gather()
            assert_tree(params, jax_ref["params"], "params vs JAX")
            assert_tree(grads, jax_ref["grads_after"], "zeroed grads vs JAX")
    sharded.update_layers(batch, lr)
    plain.update_layers(batch, lr)
    params, grads = sharded.gather()
    assert_tree(params, np_tree(plain.params), "params after the update")
    assert_tree(grads, np_tree(plain.grads), "zeroed grads")
    assert torch.equal(sharded.predict_quantized_train(xq, gt),
                       plain.predict_quantized_train(xq, gt))
    assert_tree(sharded.gather()[1], np_tree(plain.grads), "grads after the updated step")
    return sharded


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)])
def test_speech_step_matches_replicated_and_jax(jax_speech, shape, backend):
    """Speech (crossentropy, the softmax skipped): the FC's W and its
    accumulator row-sharded over ``model`` where it has a size above 1."""
    xq, gt = speech_inputs()
    tr = run_pair(lambda: speech_trainable(backend=backend, device="cpu"), cpu_mesh(*shape),
                  xq, gt, B, jax_ref=jax_speech)
    want = ("model", None) if shape[1] > 1 else ()
    assert tr.params["layer2"]["weights"].spec == want
    assert tr.grads["layer2"]["weights_gradient"].spec == want


def test_three_sharded_layers_of_sine_gather_d_in():
    """Sine with all three FCs trained (mse) on ``[2, 2]``: layers 1 and 2
    (16 rows each) are row-sharded, so the input gradient of each is
    gathered over ``model`` for the layer before it."""
    make = lambda: compile_tflite_train(model_path("sine"), 3, "mse", False, name="sine",
                                        device="cpu")
    m = make()
    x = np.random.default_rng(5).uniform(0, 2 * np.pi, (16, 1)).astype(np.float32)
    tr = run_pair(make, cpu_mesh(2, 2), m.quantize_input(x), m.quantize_target(x / 4), 16)
    specs = {k: v["weights"].spec for k, v in tr.params.items()}
    assert specs == {"layer0": (), "layer1": ("model", None), "layer2": ("model", None)}


def pd_batch(seed=2):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (B, 96, 96, 1), dtype=np.int8)
    gt = np.full((B, 2), -128, np.int8)
    gt[np.arange(B), rng.integers(0, 2, B)] = 127
    return xq, gt


@pytest.mark.parametrize("serial", [False, True], ids=["plain_sum", "serial_fold"])
def test_person_detect_data_parallel_both_fold_paths(serial, monkeypatch):
    """person_detect_trainable(10) on ``[4, 1]`` (data only): the conv/dw
    accumulators fold over the sharded batch by the plain int64 sum, or,
    with an accumulator at -2**31 + 10 (C1's input), by the serial
    saturating fold over every ``data`` cell's gradients in batch order."""
    xq, gt = pd_batch()
    sharded, plain = ShardedTrainer(person_detect_trainable(10, device="cpu"), cpu_mesh(4, 1)), \
        person_detect_trainable(10, device="cpu")
    folds = []
    real = ttrainer.optimizer.accumulate_gradient_4d_fold
    monkeypatch.setattr(ttrainer.optimizer, "accumulate_gradient_4d_fold",
                        lambda dW_b, acc, bound=None: folds.append(dW_b.shape[0]) or real(
                            dW_b, acc, bound))
    for step in range(2):
        if serial and step == 1:
            key = next(k for k, v in plain.grads.items() if v["weights_gradient"].dim() == 4)
            plain.grads[key]["weights_gradient"].fill_(-2**31 + 10)
            for c in sharded.cells:
                sharded.grads[key]["weights_gradient"].shards[c].fill_(-2**31 + 10)
        folds.clear()
        out = sharded.predict_quantized_train(xq, gt)
        sharded_folds = list(folds)
        assert torch.equal(out, plain.predict_quantized_train(xq, gt))
        assert_tree(sharded.gather()[1], np_tree(plain.grads), f"grads after step {step}")
        if serial and step == 1:
            # the serial fold of the gathered batch, on the first data cell,
            # once a conv/dw layer; no entry wraps
            assert sharded_folds and set(sharded_folds) == {B}
            assert sharded._fold_bound == 2**31
            assert int((sharded.gather()[1][key]["weights_gradient"] > 0).sum()) == 0
        else:
            assert not sharded_folds  # the plain int64 sum over data
    sharded.update_layers(B, 0.05)
    plain.update_layers(B, 0.05)
    assert_tree(sharded.gather()[0], np_tree(plain.params), "params after the update")


def test_placement_after_an_update_is_shard_params_of_the_whole():
    """After a step and an update, each shard is what ``shard_params`` makes
    of the gathered trees."""
    xq, gt = speech_inputs()
    mesh = cpu_mesh(4, 2)
    tr = ShardedTrainer(speech_trainable(device="cpu"), mesh)
    tr.predict_quantized_train(xq, gt)
    tr.update_layers(B, LR)
    params, grads = tr.gather()
    for placed, whole in ((tr.params, params), (tr.grads, grads)):
        again = shard_params(mesh, whole)
        for k, sub in placed.items():
            for n, p in sub.items():
                assert p.spec == again[k][n].spec
                for c in tr.cells:
                    assert torch.equal(p.shards[c], again[k][n].shards[c]), (k, n, c)


def test_fold_bound_is_read_only_after_an_edit(monkeypatch):
    """The conv/dw accumulators' host bound (C1's bookkeeping) on the
    shards: a plain loop of steps and updates reads nothing from the
    device; writing one shard in place has it read at the next step."""
    xq, gt = pd_batch(3)
    tr = ShardedTrainer(person_detect_trainable(10, device="cpu"), cpu_mesh(2, 1))
    reads = []
    real = tr._accumulator_bound
    monkeypatch.setattr(tr, "_accumulator_bound", lambda: reads.append(1) or real())
    for _ in range(2):
        tr.predict_quantized_train(xq, gt)
        tr.update_layers(B, 0.05)
    assert not reads
    key = next(k for k, v in tr.grads.items() if v["weights_gradient"].shards[0, 0].dim() == 4)
    tr.grads[key]["weights_gradient"].shards[1, 0].fill_(3)
    tr.predict_quantized_train(xq, gt)
    assert len(reads) == 1
    tr.predict_quantized_train(xq, gt)
    assert len(reads) == 1


def test_collectives_sum_broadcast_and_gather():
    """The in-process collectives on a ``[2, 3]`` mesh: sums along each
    axis, the index-0 piece broadcast, pieces gathered in axis order."""
    coll = Collectives(cpu_mesh(2, 3))
    parts = {c: torch.tensor([10 * c[0] + c[1]], dtype=torch.int64) for c in coll.cells}
    data = coll.all_reduce(parts, "data")
    model = coll.all_reduce(parts, "model")
    assert all(int(data[c]) == 10 + 2 * c[1] for c in coll.cells)
    assert all(int(model[c]) == 30 * c[0] + 3 for c in coll.cells)
    assert all(int(coll.broadcast(parts, "model")[c]) == 10 * c[0] for c in coll.cells)
    sizes = [1, 2, 1]
    pieces = {c: torch.full((2, sizes[c[1]]), c[1], dtype=torch.int32) for c in coll.cells}
    whole = coll.gather(pieces, "model", 1, sizes)
    assert all(whole[c].tolist() == [[0, 1, 1, 2]] * 2 for c in coll.cells)


def test_process_collectives_broadcast_within_the_process_only():
    """A process mesh's ``data`` axis lies within the process: its broadcast
    is the in-process one (no group needed), and one over ``model``, which
    the step never makes, raises instead of returning this rank's own
    tensor."""
    from microflow_tpu_torch.parallel import distributed

    mesh, cells = distributed.process_mesh([torch.device("cpu")] * 2, 2, 1)
    coll = distributed.ProcessCollectives(mesh, cells)
    parts = {c: torch.tensor([c[0] + 1]) for c in cells}
    assert all(int(coll.broadcast(parts, "data")[c]) == 1 for c in cells)
    with pytest.raises(NotImplementedError, match="'data' only"):
        coll.broadcast(parts, "model")


def test_float_gradient_mode_is_refused():
    from microflow_tpu_torch.models import sine_trainable

    with pytest.raises(NotImplementedError, match="quantized"):
        ShardedTrainer(sine_trainable(gradient_mode="float", device="cpu"), cpu_mesh(2, 1))
