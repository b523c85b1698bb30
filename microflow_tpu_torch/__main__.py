"""Command-line front door of the port: ``python -m microflow_tpu_torch <cmd>``,
the commands and arguments of ``python -m microflow_tpu``:

    python -m microflow_tpu_torch inspect models/person_detect.tflite
    python -m microflow_tpu_torch predict models/sine.tflite --fill 0.5
    python -m microflow_tpu_torch bench models/person_detect.tflite --batch 8192
    python -m microflow_tpu_torch train models/sine.tflite --epochs 4 --save ck.npz
    python -m microflow_tpu_torch synth lenet lenet.tflite
    python -m microflow_tpu_torch expansion models/person_detect.tflite

The commands that run a model take ``--device`` (default: the card; without
CUDA they raise, as every entry point of the port does; ``cpu`` runs the
kernels' plain versions) and ``--backend`` (default: ``MFT_BACKEND``, else
``auto``).  ``train`` runs a trainable backend: ``pallas`` on the card and
``xla`` on the CPU unless ``--backend`` or ``MFT_BACKEND`` names another;
a backend that bakes the weights into its kernel is refused.  An error
of the builder or the trainer (an unknown backend, one that cannot run the
graph) ends the command with its message and exit code 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .compiler.builder import BACKENDS

BACKEND_CHOICES = [None, *sorted(BACKENDS)]


def cmd_inspect(args):
    from .frontend.parser import parse
    from .utils.flops import macs_per_inference

    g = parse(args.model)
    print(f"model: {g.name}")
    print(f"input: {g.input_shape} {g.input_dtype} scale={g.input_q.scale0} zp={g.input_q.zp0}")
    print(f"output: {g.output_shape} {g.output_dtype} scale={g.output_q.scale0} "
          f"zp={g.output_q.zp0}")
    print(f"layers: {len(g.layers)}   MACs/inference: {macs_per_inference(g):,}")
    for layer in g.layers:
        name = type(layer).__name__.replace("Layer", "")
        extra = ""
        geom = getattr(layer, "geom", None)
        if geom is not None:
            extra = (f" k={geom.k_rows}x{geom.k_cols} s={geom.stride_rows}x{geom.stride_cols}"
                     f" {geom.padding.value}")
        act = getattr(layer, "activation", None)
        if act is not None:
            extra += f" act={act.value}"
        print(f"  [{layer.index:>2}] {name:<16} out={tuple(layer.out_shape)}{extra}")


def cmd_predict(args):
    from . import compile_tflite

    m = compile_tflite(args.model, backend=args.backend, device=args.device)
    shape = (args.batch, *m.graph.input_shape)
    if args.input:
        x = np.load(args.input).astype(np.float32).reshape(shape)
    else:
        x = np.full(shape, args.fill, np.float32)
    out = m.predict(x).cpu().numpy()
    np.set_printoptions(precision=8, suppress=True)
    print(out)


def cmd_bench(args):
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = args.model
    if not os.path.exists(model) and os.path.exists(os.path.join(root, model)):
        model = os.path.join(root, model)
    cmd = [sys.executable, os.path.join(root, "bench_torch.py"), "--model", model]
    for flag in ("batch", "iters", "backend", "device", "seed"):
        value = getattr(args, flag)
        if value is not None:
            cmd += [f"--{flag}", str(value)]
    sys.exit(subprocess.call(cmd))


def train_backend(backend: str | None, device) -> str:
    """The backend ``train`` runs: ``backend``, else ``MFT_BACKEND``, else the
    trainable per-op backend of the device (``pallas`` on CUDA, ``xla`` on
    the CPU)."""
    from .compiler.builder import default_backend

    if backend:
        return backend
    if os.environ.get("MFT_BACKEND"):
        return default_backend()
    return "pallas" if device.type == "cuda" else "xla"


def cmd_train(args):
    """The on-device training loop over .npy data (or a built-in retarget
    demo), as the reference's train examples run it
    (``examples/sine_train.rs:30-58``: epochs of predict_train +
    update_layers).  Returns the trained model and its inputs."""
    import torch

    from . import compile_tflite_train
    from .compiler.builder import resolve_device
    from .utils import checkpoint

    if bool(args.x) != bool(args.y):
        raise SystemExit("--x and --y must be given together")
    device = resolve_device(args.device)
    m = compile_tflite_train(
        args.model, num_train_layers=args.layers, loss=args.loss,
        skip_last_layer_train=args.skip_last, backend=train_backend(args.backend, device),
        gradient_mode=args.gradient_mode, device=device,
    )
    print(f"train: backend {m.backend} on {m.device}")
    if args.load:
        m.params = checkpoint.load_params(args.load, device)

    rng = np.random.default_rng(args.seed)
    if args.x:
        x = np.load(args.x).astype(np.float32)
        x = x.reshape(-1, *m.graph.input_shape)
        y = np.load(args.y).astype(np.float32)
        y = y.reshape(len(x), *np.asarray(m.graph.output_shape).tolist())
    else:
        # Retarget demo: fit 0.5x the model's own initial predictions on
        # a fixed random dataset (works for any graph; loss must drop).
        x = rng.uniform(0.0, 1.0, (256, *m.graph.input_shape)).astype(np.float32)
        y = 0.5 * m.predict(x).cpu().numpy()
        print("no --x/--y given: retarget demo (fit 0.5 * initial predictions)")

    gt = m.quantize_target(y)
    xt = torch.as_tensor(x, device=device)
    yt = torch.as_tensor(y, device=device)
    n = len(x)
    for epoch in range(args.epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        losses = []
        for s in range(0, n - args.batch + 1, args.batch):
            idx = order[s:s + args.batch]
            out = m.predict_train(xt[idx], gt[idx], args.lr)
            losses.append(float(((out - yt[idx].reshape(out.shape)) ** 2).mean()))
            m.update_layers(len(idx), args.lr)
        print(f"epoch {epoch:>3}  mse {np.mean(losses):.6f}")

    if args.save:
        checkpoint.save_params(args.save, m.params)
        print(f"saved params -> {args.save}")
    if args.export:
        m.export(args.export)
        print(f"exported trained model -> {args.export}")
    return m, x


def cmd_synth(args):
    from .models import synth

    data = {"lenet": synth.lenet, "full_ops": synth.full_ops}[args.kind]()
    synth.write(args.out, data)
    print(f"wrote {args.out} ({len(data)} bytes)")


def cmd_expansion(args):
    from . import compile_tflite

    m = compile_tflite(args.model, backend=args.backend, device=args.device)
    print(m.expansion(batch_size=args.batch))


def main(argv=None):
    """Run one command; returns what the command returns (``train``: the
    trained model and its inputs), for callers in the same process."""
    ap = argparse.ArgumentParser(prog="microflow_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default=None,
                       help="torch device (default: the card; cpu runs the plain versions)")

    p = sub.add_parser("inspect", help="print the parsed/folded graph IR")
    p.add_argument("model")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("predict", help="run a forward pass")
    p.add_argument("model")
    p.add_argument("--input", help=".npy file (reshaped to [batch, *input_shape])")
    p.add_argument("--fill", type=float, default=0.5, help="constant input value")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--backend", default=None, choices=BACKEND_CHOICES)
    device_arg(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("bench", help="run the throughput benchmark (bench_torch.py)")
    p.add_argument("model", nargs="?", default="models/person_detect.tflite")
    p.add_argument("--batch", type=int, default=None, help="default: bench_torch.py's, 8192")
    p.add_argument("--iters", type=int, default=None, help="default: bench_torch.py's, 200")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backend", default=None, choices=BACKEND_CHOICES)
    device_arg(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("train", help="run an on-device training loop")
    p.add_argument("model")
    p.add_argument("--layers", type=int, default=1,
                   help="number of trailing trainable layers (macro arg n)")
    p.add_argument("--loss", default="mse", choices=["mse", "crossentropy"])
    p.add_argument("--skip-last", action="store_true",
                   help="exclude the final layer from backward (macro arg)")
    p.add_argument("--gradient-mode", default="quantized", choices=["quantized", "float"])
    p.add_argument("--x", help=".npy float inputs [N, *input_shape]")
    p.add_argument("--y", help=".npy float targets [N, *output_shape]")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load", help="warm-start params from a checkpoint .npz")
    p.add_argument("--save", help="write trained params to a checkpoint .npz")
    p.add_argument("--export", help="write the trained model back to a .tflite")
    p.add_argument("--backend", default=None, choices=BACKEND_CHOICES,
                   help="default: MFT_BACKEND, else pallas on the card and xla on the CPU")
    device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("synth", help="write a synthetic test model")
    p.add_argument("kind", choices=["lenet", "full_ops"])
    p.add_argument("out")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("expansion", help="print what a forward runs, layer by layer and "
                       "kernel op by op (the reference dumps target/microflow-expansion.rs)")
    p.add_argument("model")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--backend", default=None, choices=BACKEND_CHOICES)
    device_arg(p)
    p.set_defaults(fn=cmd_expansion)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as e:
        raise SystemExit(f"microflow_tpu_torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
