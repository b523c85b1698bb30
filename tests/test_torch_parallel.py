"""The port's parallel layer (``microflow_tpu_torch/parallel/``) on the CPU,
against the JAX package's on its virtual 8-device CPU mesh
(``tests/conftest.py``): the cases of ``tests/test_parallel.py`` but the
tensor-parallel train step, with a port mesh of
``[torch.device("cpu")] * 8``.  Served outputs are held bit-equal to the
JAX ``BatchServer``'s on the same inputs; placements to the JAX
shardings."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from microflow_tpu import compile_tflite as jcompile
from microflow_tpu.parallel import BatchServer as JServer
from microflow_tpu.parallel import make_mesh as jmake_mesh
from microflow_tpu.parallel import shard_batch as jshard_batch
from microflow_tpu.parallel import shard_params as jshard_params
from microflow_tpu.train import compile_tflite_train as jcompile_train
from microflow_tpu_torch import compile_tflite, compile_tflite_train
from microflow_tpu_torch.models import model_path
from microflow_tpu_torch.parallel import (
    BatchServer,
    batch_spec,
    make_mesh,
    mesh_devices,
    replicate_params,
    shard_batch,
    shard_params,
    tp_spec,
)

CPU = torch.device("cpu")
T = 60  # seconds any one result may take


def cpu_mesh(n_data=8, n_model=1):
    return make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


@pytest.fixture(scope="module")
def jsine():
    return jcompile(model_path("sine"), name="sine")


@pytest.fixture(scope="module")
def sine():
    return compile_tflite(model_path("sine"), name="sine", device="cpu")


def serve(model, mesh, requests, *, jax_model=None, **kw):
    """Each request's result through a port server on ``mesh`` and, with
    ``jax_model``, through a JAX server on the 8-device mesh; requests are
    ``(how, x)`` with ``how`` "f32" (``submit``) or "q" (``submit_quantized``).
    Both servers are stopped before returning."""
    outs = []
    for cls, m, kwargs in ((BatchServer, model, {"mesh": mesh}), (JServer, jax_model, {})):
        if m is None:
            continue
        server = cls(m, **kwargs, **kw)
        try:
            futs = [server.submit(x) if how == "f32" else server.submit_quantized(x)
                    for how, x in requests]
            outs.append([np.asarray(f.result(timeout=T)) for f in futs])
        finally:
            server.stop()
    return outs


# --- mesh and placement -------------------------------------------------------


def test_mesh_devices_raises_without_enough_cuda():
    """No fallback to the CPU (the JAX package falls back to its virtual
    CPU devices)."""
    with pytest.raises(RuntimeError, match="CUDA devices"):
        mesh_devices(min_devices=torch.cuda.device_count() + 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            mesh_devices(min_devices=2)
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh()


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4)])
def test_mesh_shape_matches_jax(n_data, n_model):
    mesh, jmesh = cpu_mesh(n_data, n_model), jmake_mesh(n_data=n_data, n_model=n_model)
    assert mesh.shape == dict(jmesh.shape) == {"data": n_data, "model": n_model}
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.devices.shape == jmesh.devices.shape
    assert mesh.data_devices == [CPU] * n_data


def test_make_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(4, 2, devices=[CPU] * 6)


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2)])
def test_shard_batch_matches_jax(n_data, n_model):
    """Chunk ``i`` of dim 0 on every device of ``data`` index ``i``, as the
    JAX batch sharding places it."""
    x = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    jmesh = jmake_mesh(n_data=n_data, n_model=n_model)
    jshards = {s.device: np.asarray(s.data) for s in jshard_batch(jmesh, x).addressable_shards}
    placed = shard_batch(cpu_mesh(n_data, n_model), x)
    assert placed.spec == batch_spec(2) == ("data", None)
    for (i, j), piece in np.ndenumerate(placed.shards):
        assert np.array_equal(piece.numpy(), jshards[jmesh.devices[i, j]]), (i, j)


def test_batch_sharded_predict_matches_single_device(sine, jsine):
    mesh = cpu_mesh()
    xs = np.linspace(0.0, 2 * np.pi, 64, dtype=np.float32).reshape(-1, 1)
    chunks = shard_batch(mesh, sine.quantize_input(xs)).shards[:, 0]
    out = torch.cat([sine.predict_quantized(c) for c in chunks])
    assert torch.equal(out, sine.predict(xs))
    assert np.array_equal(out.numpy(), np.asarray(jsine.predict(xs)))


def test_replicate_params_one_copy_a_device(sine):
    placed = replicate_params(cpu_mesh(), sine.params)
    assert list(placed) == [CPU]
    for key, sub in sine.params.items():
        for name, t in sub.items():
            assert placed[CPU][key][name] is t  # already there: not copied


@pytest.fixture(scope="module")
def trees():
    """params and grads of speech's and person_detect's trainers in both
    packages."""
    out = {}
    for name, layers in (("speech", 2), ("person_detect", 10)):
        jm = jcompile_train(model_path(name), layers, "crossentropy", True, name=name)
        tm = compile_tflite_train(model_path(name), layers, "crossentropy", True, name=name,
                                  device="cpu")
        out[name] = {"params": (tm.params, jm.params), "grads": (tm.grads, jm.grads)}
    return out


@pytest.mark.parametrize("name", ["speech", "person_detect"])
@pytest.mark.parametrize("tree", ["params", "grads"])
@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4), (8, 1)])
def test_tp_placement_matches_jax(trees, name, tree, n_data, n_model):
    """``shard_params(policy="tp")`` picks the JAX policy's leaves and axes;
    a row-sharded leaf's shards are the JAX shards and concatenate back to
    the leaf, bit for bit; every other leaf is whole on every device."""
    port, ref = trees[name][tree]
    jmesh = jmake_mesh(n_data=n_data, n_model=n_model)
    placed = shard_params(cpu_mesh(n_data, n_model), port, policy="tp")
    jplaced = jshard_params(jmesh, ref, policy="tp")
    sharded = 0
    for key, sub in port.items():
        for leaf, arr in sub.items():
            p, j = placed[key][leaf], jplaced[key][leaf]
            assert p.spec == tuple(j.sharding.spec), (key, leaf)
            # a model axis of size 1 replicates everything
            assert p.spec == (tp_spec(leaf, arr, n_model, 2 * n_model) if n_model > 1 else ())
            jshards = {s.device: np.asarray(s.data) for s in j.addressable_shards}
            for (i, k), piece in np.ndenumerate(p.shards):
                assert np.array_equal(piece.numpy(), jshards[jmesh.devices[i, k]]), (key, leaf)
            for i in range(n_data):
                whole = (torch.cat(list(p.shards[i])) if p.spec else p.shards[i, 0])
                assert torch.equal(whole, arr), (key, leaf)
            sharded += p.spec == ("model", None)
    # speech's FC weights (4000 x 4) and their accumulator are row-sharded;
    # person_detect has no 2-D leaf
    assert sharded == (1 if name == "speech" and n_model > 1 else 0)


def test_shard_params_replicate_callable_and_unknown_policies(sine):
    mesh = cpu_mesh(4, 2)
    for key, sub in shard_params(mesh, sine.params, policy="replicate").items():
        for leaf, p in sub.items():
            assert p.spec == ()
            assert all(torch.equal(s, sine.params[key][leaf]) for s in p.shards.flat)
    custom = shard_params(mesh, sine.params,
                          policy=lambda key, name, arr: ("model",) if name == "c0" else None)
    for key, sub in custom.items():
        assert sub["c0"].spec == ("model",) and sub["weights"].spec == ()
        assert torch.equal(torch.cat(list(sub["c0"].shards[0])), sine.params[key]["c0"])
    with pytest.raises(ValueError, match="unknown sharding policy"):
        shard_params(mesh, sine.params, policy="bogus")


# --- the server -----------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batch_server_roundtrip(jsine, backend):
    """Eight requests coalesced on the 8-device mesh; the port's per-op
    kernel backend runs its kernels' plain versions on the CPU."""
    model = compile_tflite(model_path("sine"), name="sine", backend=backend, device="cpu")
    xs = np.linspace(0.0, 2 * np.pi, 40, dtype=np.float32).reshape(-1, 1)
    reqs = [("f32", xs[i : i + 5]) for i in range(0, 40, 5)]
    got, want = serve(model, cpu_mesh(), reqs, jax_model=jsine, max_batch=64, max_wait_ms=1.0)
    for g, w, (_, x) in zip(got, want, reqs):
        assert g.dtype == np.float32 and np.array_equal(g, w)
        assert np.array_equal(g, model.predict(x).numpy())


def test_batch_server_golden(sine, jsine):
    got, want = serve(sine, cpu_mesh(), [("f32", np.array([[0.5]], np.float32))],
                      jax_model=jsine, max_batch=16)
    assert got[0][0, 0] == np.float32(0.41348344) == want[0][0, 0]


def test_batch_server_results_are_cpu_f32_tensors(sine):
    server = BatchServer(sine, mesh=cpu_mesh(), max_batch=16)
    try:
        out = server.submit(np.array([[0.5], [1.0]], np.float32)).result(timeout=T)
    finally:
        server.stop()
    assert isinstance(out, torch.Tensor) and out.device == CPU and out.dtype == torch.float32
    assert out.shape == (2, 1)


def test_batch_server_concurrent_clients(sine, jsine):
    """16 threads submitting at once: every waiter gets its own rows back,
    equal to the JAX server's answer to the same request."""
    server = BatchServer(sine, mesh=cpu_mesh(), max_batch=128, max_wait_ms=2.0)
    results, errors = {}, []
    try:
        def client(i):
            try:
                xs = np.full((3, 1), 0.1 * (i % 7), np.float32)
                results[i] = server.submit(xs).result(timeout=T).numpy()
            except Exception as e:  # surfaced to the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    assert not errors, errors
    assert len(results) == 16
    reqs = [("f32", np.full((3, 1), 0.1 * i, np.float32)) for i in range(7)]
    (want,) = serve(None, None, reqs, jax_model=jsine, max_batch=128)
    for i, got in results.items():
        assert np.array_equal(got, want[i % 7]), i


def test_batch_server_oversize_coalesce_with_warm(sine, jsine):
    """Two 14-row requests coalesce to 28 > max_batch=16, and one request of
    40 rows: every dispatch is chunked at max_batch and padded to a bucket,
    after warm(16, cache=False)."""
    xs = np.linspace(-1.0, 1.0, 28, dtype=np.float32).reshape(-1, 1)
    big = np.linspace(0.0, 2.0, 40, dtype=np.float32).reshape(-1, 1)
    out = {}
    for cls, m, kw in ((BatchServer, sine, {"mesh": cpu_mesh()}), (JServer, jsine, {})):
        server = cls(m, max_batch=16, max_wait_ms=50.0, **kw)
        try:
            server.warm(16, cache=False)
            futs = [server.submit(xs[:14]), server.submit(xs[14:])]
            out[cls] = (np.concatenate([np.asarray(f.result(timeout=T)) for f in futs]),
                        np.asarray(server.submit(big).result(timeout=T)))
            if cls is BatchServer:
                st = server.stats()
        finally:
            server.stop()
    assert all(np.array_equal(a, b) for a, b in zip(out[BatchServer], out[JServer]))
    assert np.array_equal(out[BatchServer][0], sine.predict(xs).numpy())
    assert np.array_equal(out[BatchServer][1], sine.predict(big).numpy())
    # 28 rows: 16 + 12 (bucket 16); 40 rows: 16 + 16 + 8
    assert st["batches_dispatched"] == 5 and st["rows_padded"] == 4


def test_batch_server_warm_twice_and_restart(sine):
    """warm(bucket) runs the bucket's dispatch once and records it; a
    restarted server warms again and gives the same bits (on the card the
    second server builds nothing: chip_smoke.py phase 9)."""
    xs = np.linspace(-1.0, 1.0, 16, dtype=np.float32).reshape(-1, 1)
    got = []
    for _ in range(2):
        server = BatchServer(sine, mesh=cpu_mesh(), max_batch=16, max_wait_ms=1.0)
        try:
            server.warm(16)
            server.warm(16, cache=True)
            assert server._warmed == {16}
            assert server.stats()["batches_dispatched"] == 0  # warm is not served traffic
            got.append(server.submit(xs).result(timeout=T))
        finally:
            server.stop()
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], sine.predict(xs))


def test_batch_server_device_resident_and_mixed_requests(sine, jsine):
    """A tensor already on a mesh device (the CPU here), host int8 and host
    f32 in one window, under-filling the bucket (the pad path)."""
    xs = np.linspace(-1.0, 1.0, 20, dtype=np.float32).reshape(-1, 1)
    xq = sine.quantize_input(xs)
    port_reqs = [("q", xq[:8].clone()), ("q", xq[8:14].numpy()), ("f32", xs[14:])]
    jxq = np.asarray(jsine.quantize_input(xs))
    jax_reqs = [("q", jax.device_put(jxq[:8])), ("q", jxq[8:14]), ("f32", xs[14:])]
    (got,) = serve(sine, cpu_mesh(), port_reqs, max_batch=32, max_wait_ms=20.0)
    jserver = JServer(jsine, max_batch=32, max_wait_ms=20.0)
    try:
        futs = [jserver.submit(x) if how == "f32" else jserver.submit_quantized(x)
                for how, x in jax_reqs]
        want = [np.asarray(f.result(timeout=T)) for f in futs]
    finally:
        jserver.stop()
    assert np.array_equal(np.concatenate(got), np.concatenate(want))
    assert np.array_equal(np.concatenate(got), sine.predict(xs).numpy())


def test_batch_server_rejects_malformed_requests(sine):
    server = BatchServer(sine, mesh=cpu_mesh(), max_batch=16)
    try:
        with pytest.raises(ValueError, match="shape"):
            server.submit_quantized(np.zeros((2, 3), np.int8))
        with pytest.raises(ValueError, match=">= 1"):
            server.submit_quantized(np.zeros((0, 1), np.int8))
        with pytest.raises(TypeError, match="dtype"):
            server.submit_quantized(np.zeros((2, 1), np.float32))
        with pytest.raises(ValueError, match="not a device of the mesh"):
            server.submit_quantized(torch.zeros((2, 1), dtype=torch.int8, device="meta"))
        assert server.stats()["requests_submitted"] == 0
    finally:
        server.stop()


def test_batch_server_stats_counters(sine, jsine):
    """The counters account for every request, inference, dispatch, pad row
    and failure, as the JAX server's do on the same traffic."""
    xs = np.linspace(0, 1, 10, dtype=np.float32).reshape(10, 1)
    snaps, outs = {}, {}
    for cls, m, kw in ((BatchServer, sine, {"mesh": cpu_mesh()}), (JServer, jsine, {})):
        server = cls(m, max_batch=16, max_wait_ms=1.0, **kw)
        try:
            first = np.asarray(server.submit(xs).result(timeout=T))  # one request of 10 rows
            with pytest.raises(TypeError):  # refused at submission: no counter moves
                server.submit_quantized(np.zeros((2, 1), np.float32))
            bucket = server._bucket
            server._bucket = lambda n: (_ for _ in ()).throw(RuntimeError("boom"))
            f = server.submit(xs[:2])
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=T)
            server._bucket = bucket
            last = np.asarray(server.submit(xs[:3]).result(timeout=T))  # the loop survives
            for _ in range(200):
                s = server.stats()
                if s["requests_completed"] >= 2 and s["requests_failed"] >= 1:
                    break
                time.sleep(0.05)
        finally:
            server.stop()
        snaps[cls], outs[cls] = s, (first, last)
    s = snaps[BatchServer]
    assert s["requests_submitted"] == 3
    assert s["requests_completed"] == 2
    assert s["requests_failed"] == 1
    assert s["inferences_completed"] == 13
    assert s["batches_dispatched"] == 2
    assert s["rows_padded"] == (16 - 10) + (8 - 3)  # buckets 16 and 8 (the mesh's 8 devices)
    assert s["busy_seconds"] > 0
    assert s["queue_depth"] == 0
    keys = ("requests_submitted", "requests_completed", "requests_failed",
            "inferences_completed", "batches_dispatched", "rows_padded", "queue_depth")
    assert {k: s[k] for k in keys} == {k: snaps[JServer][k] for k in keys}
    assert all(np.array_equal(a, b) for a, b in zip(outs[BatchServer], outs[JServer]))


def test_person_detect_on_a_two_device_mesh(tmp_path):
    """person_detect through a 2-device CPU mesh, one replica of its own on
    the second device (``torch.device("cpu", 0)`` is another device than
    ``"cpu"`` to the mesh), bit-equal to the JAX ``person_detect().predict``."""
    from microflow_tpu.models import person_detect as jperson_detect

    model = compile_tflite(model_path("person_detect"), name="person_detect", device="cpu")
    mesh = make_mesh(devices=[CPU, torch.device("cpu", 0)])
    rng = np.random.default_rng(0)
    reqs = [("f32", rng.uniform(0, 1, (n, 96, 96, 1)).astype(np.float32)) for n in (1, 3, 2)]
    server = BatchServer(model, mesh=mesh, max_batch=8, max_wait_ms=20.0)
    try:
        assert server.replicas[0] is model and server.replicas[1] is not model
        assert server.replicas[1].device == torch.device("cpu", 0)
        futs = [server.submit(x) for _, x in reqs]
        got = np.concatenate([f.result(timeout=T).numpy() for f in futs])
    finally:
        server.stop()
    want = np.asarray(jperson_detect().predict(np.concatenate([x for _, x in reqs])))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("backend", ["xla", "colfc"])
def test_replicas_serve_the_models_params(backend):
    """A replica on another device carries the model's current params (a
    swapped set on a per-op backend); a backend that bakes its weights
    builds them from the graph."""
    model = compile_tflite(model_path("sine"), name="sine", backend=backend, device="cpu")
    if backend == "xla":
        model.params = {k: {**v, "c0": v["c0"] + 3.0} for k, v in model.params.items()}
    mesh = make_mesh(devices=[torch.device("cpu", 0), CPU])
    xs = np.linspace(-3.0, 3.0, 12, dtype=np.float32).reshape(-1, 1)
    server = BatchServer(model, mesh=mesh, max_batch=16)
    try:
        assert server.replicas[0] is not model and server.replicas[1] is model
        got = server.submit(xs).result(timeout=T)
    finally:
        server.stop()
    assert torch.equal(got, model.predict(xs))


def test_default_mesh_of_a_cpu_model_is_its_device(sine):
    server = BatchServer(sine, max_batch=16)
    try:
        assert server.mesh.shape == {"data": 1, "model": 1}
        assert server.mesh.data_devices == [CPU] and server.replicas == [sine]
        assert torch.equal(server.submit(np.array([[0.5]], np.float32)).result(timeout=T),
                           sine.predict(np.array([[0.5]], np.float32)))
    finally:
        server.stop()
