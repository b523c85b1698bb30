"""Batch-serving executor with continuous admission: the port of
``microflow_tpu.parallel.executor``.

Where the reference runs one sample per ``predict()`` call on one MCU core
(``examples/sine_train.rs:36-84``), this executor accepts requests
continuously from any number of threads, coalesces them into power-of-two
buckets, and dispatches each bucket split across the mesh's ``data``
devices, each chunk through that device's replica of the model.  CUDA
launches are asynchronous and every chunk is launched before the first
copy back to the host, so the devices run their chunks at once (the JAX
server's asynchronous dispatch).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..compiler.builder import build
from ..core.numerics import torch_dtype
from .mesh import Mesh, canonical, make_mesh, replicate_params


class BatchServer:
    """Serves ``model`` (a ``CompiledModel``) on ``mesh``.

    ``mesh`` defaults to every CUDA device when the model is on CUDA, and
    to the model's own device when it is on the CPU.  Each ``data`` index
    of the mesh gets a replica of the model on its device: the model itself
    where the device is the model's, else ``build(model.graph,
    backend=model.backend, device=d)`` carrying ``replicate_params``' copy
    of the model's params (a backend that bakes its weights at build makes
    them from the graph).  A dispatch runs through the replicas' own
    backend: a model on CUDA serves through its kernels, never through the
    plain ops.

    Each future resolves to the request's f32 output rows as a
    ``torch.Tensor`` on the CPU: the host copy that the JAX server hands
    back as a numpy array.  A failed dispatch fails the futures of every
    request in it; the server goes on with the next.
    """

    def __init__(self, model, mesh: Mesh | None = None, max_batch: int = 1024,
                 max_wait_ms: float = 2.0):
        self.model = model
        if mesh is None:
            device = canonical(model.device)
            mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.params = replicate_params(self.mesh, model.params)
        self.replicas = [self._replica(d) for d in self.mesh.data_devices]
        self._in_dtype = torch_dtype(model.graph.input_dtype)
        self._devices = set(self.mesh.devices.flat)
        self._warmed: set = set()  # buckets warm() has run
        self._dispatch_lock = threading.Lock()  # the worker's dispatch and warm()
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # serving counters, guarded by _metrics_lock; snapshot via stats()
        self._metrics_lock = threading.Lock()
        self._metrics = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "requests_failed": 0,
            "inferences_completed": 0,
            "batches_dispatched": 0,
            "rows_padded": 0,  # bucket padding overhead (rows)
            "busy_seconds": 0.0,  # worker time spent dispatching
        }
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _replica(self, device: torch.device):
        if device == canonical(self.model.device):
            return self.model
        replica = build(self.model.graph, backend=self.model.backend, device=device)
        if not replica.baked:
            replica.params = self.params[device]
        return replica

    # --- client API ---

    def warm(self, bucket: int, cache: bool = True) -> None:
        """Build every replica's kernels and run one zero batch of
        ``bucket`` rows through the dispatch path, so that the first request
        of that bucket pays no build; records the bucket in ``_warmed``.

        The port has no per-bucket executable to keep: a kernel's plan does
        not depend on the batch.  What persists across processes is each
        kernel's library under ``build/torch_ext/`` and the native front
        end's under ``build/native/``, both keyed by a hash of their sources,
        so a restarted server runs neither ``nvcc`` nor ``g++``.  That holds
        whatever ``cache`` says: the argument is kept for the JAX server's
        signature (where ``cache=True`` persists the compiled executable)
        and changes nothing here."""
        g = self.model.graph
        xs = torch.zeros((bucket, *g.input_shape), dtype=self._in_dtype)
        with self._dispatch_lock:
            for y in self._launch(xs):
                y.cpu()
        self._warmed.add(bucket)

    def _check_request(self, xq: torch.Tensor) -> torch.Tensor:
        """Reject malformed requests at submission, before they reach the
        admission thread."""
        g = self.model.graph
        want = tuple(g.input_shape)
        if xq.ndim != 1 + len(want) or tuple(xq.shape[1:]) != want:
            raise ValueError(f"request shape {tuple(xq.shape)} != [b, *{want}]")
        if xq.shape[0] < 1:
            raise ValueError("request batch must be >= 1")
        if xq.dtype != self._in_dtype:
            raise TypeError(f"request dtype {xq.dtype} != model input {self._in_dtype}")
        if xq.device.type != "cpu" and xq.device not in self._devices:
            raise ValueError(f"request on {xq.device}, which is not a device of the mesh "
                             f"{self.mesh}")
        return xq

    def _enqueue(self, xq: torch.Tensor) -> Future:
        fut: Future = Future()
        self._queue.put((self._check_request(xq), fut))
        self._count(requests_submitted=1)
        return fut

    def submit(self, x) -> Future:
        """Enqueue a [b, *input_shape] f32 request (numpy or a tensor); the
        model quantizes it on its device.  Resolves to the f32 output rows
        on the CPU."""
        return self._enqueue(self.model.quantize_input(x))

    def submit_quantized(self, xq) -> Future:
        """Enqueue an already-quantized [b, *input_shape] request of the
        model's input dtype: a numpy array, a CPU tensor, or a tensor on a
        device of the mesh.  Resolves like ``submit``.  Requests on a device
        are coalesced and padded with torch on that device, so the
        admission path moves no request bytes through the host."""
        if not isinstance(xq, torch.Tensor):
            xq = torch.from_numpy(np.ascontiguousarray(xq))
        return self._enqueue(xq)

    def predict(self, x) -> torch.Tensor:
        """``submit(x)`` and wait for its rows."""
        return self.submit(x).result()

    def stats(self) -> dict:
        """Snapshot of the serving counters: requests submitted /
        completed / failed, inferences completed, batches dispatched,
        bucket-padding rows, queue depth, and the worker's cumulative
        dispatch time (``busy_seconds``)."""
        with self._metrics_lock:
            snap = dict(self._metrics)
        snap["queue_depth"] = self._queue.qsize()
        return snap

    def _count(self, **deltas):
        with self._metrics_lock:
            for k, v in deltas.items():
                self._metrics[k] += v

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # --- admission loop ---

    def _bucket(self, n: int) -> int:
        b = max(self.mesh.devices.size, 1)
        while b < n and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)

    def _launch(self, xs: torch.Tensor) -> list[torch.Tensor]:
        """``xs`` split into one contiguous chunk per ``data`` device, each
        launched through that device's replica; the outputs stay on their
        devices."""
        chunks = torch.tensor_split(xs, len(self.replicas))
        return [r.predict_quantized(c.to(d))
                for r, c, d in zip(self.replicas, chunks, self.mesh.data_devices)]

    def _dispatch(self, requests: list[torch.Tensor]) -> tuple[torch.Tensor, int, int]:
        """Run coalesced requests: ``(f32 output rows on the CPU, batches
        dispatched, rows padded)``."""
        # requests on a device are coalesced and padded there; host requests
        # join them on it
        dev = next((r.device for r in requests if r.device.type != "cpu"), torch.device("cpu"))
        xs_all = requests[0] if len(requests) == 1 else torch.cat([r.to(dev) for r in requests])
        # Dispatch in chunks of at most max_batch: coalescing can overshoot
        # (request sizes needn't divide the window, and a single request may
        # exceed max_batch), and every dispatched batch is padded to exactly
        # one bucket, by repeating its last row.
        outs, padded = [], 0
        with self._dispatch_lock:
            for start in range(0, xs_all.shape[0], self.max_batch):
                xs = xs_all[start : start + self.max_batch]
                n = xs.shape[0]
                bucket = self._bucket(n)
                if n < bucket:
                    xs = torch.cat([xs, xs[-1:].expand(bucket - n, *xs.shape[1:])])
                    padded += bucket - n
                outs.append((self._launch(xs), n))
            # every chunk is launched before the first copy to the host
            ys = torch.cat([torch.cat([y.cpu() for y in ys_dev])[:n] for ys_dev, n in outs])
        return ys, len(outs), padded

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            t_busy = time.monotonic()
            try:
                total = first[0].shape[0]
                # coalesce whatever arrives within the admission window
                while total < self.max_batch:
                    try:
                        item = self._queue.get(timeout=self.max_wait_s)
                    except queue.Empty:
                        break
                    batch.append(item)
                    total += item[0].shape[0]
                ys, dispatched, padded = self._dispatch([xq for xq, _ in batch])
                off = 0
                for xq, fut in batch:
                    n = xq.shape[0]
                    fut.set_result(ys[off : off + n])
                    off += n
                self._count(requests_completed=len(batch),
                            inferences_completed=int(off),
                            batches_dispatched=dispatched,
                            rows_padded=padded,
                            busy_seconds=time.monotonic() - t_busy)
            except Exception as e:  # the loop must survive: fail every waiter of this batch
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                self._count(requests_failed=len(batch),
                            busy_seconds=time.monotonic() - t_busy)
