#!/usr/bin/env python3
"""Smoke run of the torch port (``microflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card (an H100:
the kernels are built for ``sm_90a``).  Phases, each printing one JSON
line; any failure raises and the script exits non-zero:

1. device: CUDA must be present; the card's name and power limit.
2. build: the eight kernels of ``microflow_tpu_torch/csrc/`` with ``nvcc``,
   in parallel; ``ptxas`` registers, stack and spills of every entry
   function, and a check that the exact2 flat kernel, the megakernel and
   the packed kernel keep 64 registers, no stack and no spills, and that
   ``qgemm``'s tensor-core (``qgemm_mma``) and narrow-path
   (``qgemm_rows``) instantiations and ``colfc``'s ``col_kernel`` have no
   stack and no spills.
3. kernels: each kernel held bit-equal against its plain torch version:
   ``qgemm``/``qdwconv`` at every layer shape of sine, speech and
   person_detect (batch 64) and on edge cases (``qgemm``'s: the epilogue
   triples (ties made from (q, bias0, c1), FMA-sensitive columns, q around
   2**22 and past 2**24) on the narrow path at K = 4, 8, 16 and 32 and on
   the tensor cores at K = 128, every (M, K, N) of ``QGEMM_ROWS_EDGES`` and
   of ``QGEMM_MMA_EDGES``, and X at 1 and 4 bytes past an aligned address
   on both paths, each check naming its path, counted per path on the
   phase's line; ``qdwconv``'s, on its
   unpadded input, at the edges of its 3x3 tile paths and of its general
   path: ``DW_EDGE_CASES``); ``flatpack`` on
   person_detect (whole, and its first 2 and 12 layers), speech and sine at
   batches 64, 3 and 0, on a small conv graph (and two prefixes) whose
   ops take the kernel's general paths, on a graph of 1x1 convs at the
   edges of its tensor-core path (``pw_edge_graph``; the phase prints how
   many ops of each plan take ``mma.sync``: 13 of person_detect's, layers
   2-26) and on a graph of 3x3 depthwise convs at the edges of its 3x3
   depthwise path (``dw_edge_graph``; the phase prints how many ops of each
   plan take that path: all 14 of person_detect's depthwise ops); every
   input holds -128 and 127; ``colfc`` on sine in both compute
   modes at batch 1000 and on the fabricated chains ``COL_CHAINS`` (widths
   3, 5, 7, 9, 31, 32; K0 32 and 17; five layers; in_zp != 0; per-channel
   c1; a RELU whose out_zp lifts the padded columns) at batches 0, 1, 15,
   17 and 1000, in both modes and with x one byte off alignment;
   ``megakernel`` on every segment of person_detect's
   ``fused`` and ``hybrid`` forwards, speech's and sine's ``fused``, the
   conv graph and its variant with a leading Quantize and nonzero weight
   zero points, ``pw_edge_graph``, ``dw_edge_graph`` and its variant with
   nonzero per-channel weight zero points (``dw_edge_graph(wzp=True)``),
   at batches 64, 3 and 0 (the phase prints how many ops of each take each
   of the kernel's paths: person_detect's 14 depthwise ops on the 3x3
   strips and 13 1x1 convs on ``mma.sync``);
   ``packed`` on person_detect's prefixes (whole, 5, 9 and 15 layers), a
   small packable graph and ``packed_edge_graph`` (every general path of
   the kernel and ``op_dw_vec``, and a tensor-core 1x1 conv whose
   epilogue sits on the exact2 corners, on +-k.5 and past both rails) at
   batches 64, 3 and 0 (the phase prints each plan's paths, person_detect's
   12 depthwise ops on the strips and 11 1x1 convs on ``mma.sync``, and
   how many outputs the plan's exact2 mutant would change); ``flatpack_fixed`` (the
   flat kernel with ``requant="fixed"``, the integer (M, S) epilogue, its
   own instantiation ``flat_kernel<R_FIXED>``) on person_detect (whole, 2 and
   12 layers), speech and sine at batches 64, 3 and 0, on the conv graph,
   ``pw_edge_graph`` and ``dw_edge_graph``, and on three fixed-epilogue edge
   graphs (``fixed_edge_graph``: p exactly on +-(k + 0.5) and the ulps
   around it, both rails, q past +-2**24, with no activation, RELU and
   RELU6, out_zp != 0; the phase prints what each met); the flat kernel's
   measurement-only ``raw`` and ``noround`` (``flat_kernel<R_RAW>``,
   ``<R_NOROUND>``) on person_detect and speech at batches 1024, 3 and 0,
   on the conv graph, ``pw_edge_graph`` and ``dw_edge_graph``, and on an
   edge graph each (``raw_edge_graph``: accumulators outside int8;
   ``noround_edge_graph``: y past both rails and outside a RELU6's bounds;
   the phase prints what each met); ``flatpack``, ``colfc``
   and ``megakernel`` on two small FC graphs whose constants put the
   epilogue on the ``exact2`` corners (counted: the megakernel rounds half
   away there), on +-k.5 and the ulps around them, past both rails, and on
   multiply-add triples that an FMA would round otherwise.  Then each is
   timed beside its plain version and its bound: the per-op kernels at
   person_detect's shapes at batch 8192 and ``qgemm`` at sine's three
   shapes at batch 1,048,576 (``qgemm`` also beside
   ``torch._int_mm``, both also on the device alone, replayed from a CUDA
   graph, and on its other path, each shape naming the path the rule
   gives it; ``qdwconv`` beside cuDNN's depthwise ``conv2d`` in
   f32 with TF32 off on the padded input, the stem's channel repeated to
   all 8, made outside the timed call, first checked equal to the integer
   accumulators),
   ``flatpack`` on person_detect and speech at batch
   8192 (person_detect: exact2, then ``flatpack_fixed``, ``raw`` and
   ``noround`` on the same input, with exact2 again after the fixed and
   after the last), ``colfc`` on sine at batch 1,048,576, ``megakernel`` (person_detect's
   fused segment) and ``packed`` (its prefix) at batch 8192, ``packed``
   beside the flat kernel in ``exact`` mode on the same 23 layers (the
   same plan; the two outputs checked equal), then again.  Last, sine at
   batches 1024, 1,048,576 and 16,777,216 through ``colfc``, the ``pallas`` path
   (its three ``qgemm`` launches) and the flat kernel: call ms and device ms
   (replayed from a CUDA graph) beside the bound, each output checked equal
   to ``colfc_reference``.
4. main paths, each driven with the launch counts set to 0 just before it
   and read just after: the three Rust goldens through ``compile_tflite``
   with the default backend (``"flat"`` for person_detect and speech,
   ``"pallas"`` for sine) and 4 person_detect requests (4 ``flatpack``
   launches, no per-op kernel); the same 4 requests through
   ``backend="pallas"`` (slice 1's path: 14 ``qgemm``, 14 ``qdwconv`` and
   1 ``qsoftmax`` launches a forward); 4 sine requests through ``backend="colfc"``; the 4
   person_detect requests through ``"fused"`` (1 ``megakernel`` launch a
   forward), ``"hybrid"`` (1 ``megakernel``, 5 ``qdwconv``, 4 ``qgemm``)
   and ``"packed"`` (1 ``packed``, 2 ``qdwconv``, 3 ``qgemm``, 1
   ``qsoftmax``), each with
   person_detect's golden, and the sine and speech goldens through
   ``"fused"`` and ``"hybrid"``; 4 speech requests through ``"fused"`` (2
   ``megakernel`` launches a forward); the 4 person_detect requests through
   ``backend="auto"`` with ``MFT_FLAT_REQUANT=fixed`` (4 ``flatpack_fixed``
   launches, no other kernel; their distance from ``xla`` printed), then
   the JAX package's gate for that mode (``tests/test_flatpack.py``: its 8
   random int8 samples within 2 LSB of ``xla``); the 4 requests through
   ``"auto"`` with ``MFT_FLAT_REQUANT=raw`` and ``=noround`` (4 launches of
   the mode's instantiation each, no other kernel, finite outputs: not
   exact by design).
5. whole model: ``flat``, ``pallas``, ``fused``, ``hybrid``, (sine)
   ``colfc`` and (person_detect) ``packed`` bit-equal to the plain torch
   backend ``xla`` on random int8 inputs, batch 1024; ``flat`` with
   ``MFT_FLAT_REQUANT=fixed`` on person_detect and speech bit-equal to the
   plain fixed flat forward, and its largest deviation from ``xla`` and
   how many outputs differ (printed, not gated).
6. throughput: ``predict_inner`` inferences/s of person_detect through
   ``flat`` and ``pallas`` in turns (flat, pallas, pallas, flat) at batch
   8192 and 32768, and of speech at batch 8192; then person_detect through
   ``flat`` with ``MFT_FLAT_REQUANT`` exact2, fixed, fixed, exact2 at batch
   8192; then through ``fused``, ``hybrid`` and ``packed``, once each.

7. train: ``person_detect_trainable(10)``, ``speech_trainable`` and
   ``sine_trainable`` (also in ``gradient_mode="float"``), each as a trainer
   on ``"pallas"`` and one on ``"xla"`` from the same params, 3 steps of
   ``predict_quantized_train`` and ``update_layers`` at batch 256 on seeded
   int8 inputs and targets: grads after every step and params after every
   update bit-equal; each trained layer's count of nonzero gradient entries
   (every layer must have some); a person_detect step launches 14 ``qgemm``,
   14 ``qdwconv``, 1 ``qsoftmax`` and 4 ``qwgrad`` through ``"pallas"`` and
   the 4 ``qwgrad`` alone through ``"xla"``.  ``qwgrad`` (the 1x1 convs'
   folded weight gradients) equal to its plain version at person_detect's
   four 1x1 shapes at batch 1024 (timed beside it and its bound) and on
   planted edge inputs (``qwgrad_cases``); person_detect_trainable(10) on
   the card bit-equal to the same on the CPU, 3 steps at batch 64.
   Then ms a train step and an ``update_layers`` of person_detect at batch
   1024 through ``"pallas"`` and ``"xla"`` in turns, with the card's name
   and power limit.
8. entry_points: ``bench_torch.py --batch 8192`` (its JSON line, the golden
   passed, its ms per batch), ``python -m microflow_tpu_torch inspect`` of
   person_detect, ``predict`` of sine (the golden ``0.41348344`` printed)
   and ``expansion`` of person_detect (naming ``flat_kernel``), as
   subprocesses; the real samples (``samples.load_features()``) through the
   default backend, ``flat``: person_detect's and speech's pinned outputs
   and labels, 4 ``flatpack`` launches and no other; the three models
   exported and reparsed, equal ``predict_inner`` bits at batch 1024; the
   CLI's ``train`` in process on person_detect (10 layers, crossentropy,
   the softmax skipped, 1 epoch of the retarget demo at batch 256) through
   its default ``pallas``, with ``--save`` and ``--export``: the export,
   compiled with the default backend (``flat``), bit-equal on the training
   inputs to the trained weights run per op with the C0s the export
   quantized to integer biases, and its distance from the trained model
   printed (the rounded C0s move an intermediate output across a rounding
   edge now and then, and the layers after it carry that on: up to 2 LSB
   at the softmax); the checkpoint loaded into a fresh ``pallas`` trainer
   bit-equal to the trained model.
9. serve: the native front end (``parse(frontend="native")`` equal to
   ``"python"`` in every field on the three models; the reader
   ``compile_tflite`` used, printed); person_detect through a
   ``BatchServer`` on the default backend (``flat``) and mesh (the card),
   ``max_batch`` 1024, after ``warm(64)`` and ``warm(1024)``: 16 client
   threads of 8 requests of 1-300 rows (host f32 through ``submit``, host
   int8 and int8 already on the card through ``submit_quantized``) and one
   of 1500 rows; every result bit-equal to ``predict_inner`` on its rows,
   dequantized; the golden through the server; one ``flatpack`` launch a
   dispatched batch and no other kernel; the counters account for every
   request, inference and pad row (each forward's batch a power of two up
   to 1024).  The same load again with every request on the card; sine
   through ``pallas`` (4 clients, 3 ``qgemm`` launches a batch).  A second
   process, with ``CUDA_HOME=/nonexistent``, warms a server and serves the
   person_detect golden without building: every library under
   ``build/torch_ext/`` and ``build/native/`` keeps its mtime.  Printed,
   not gated: each load's inferences/s beside ``predict_inner``'s at batch
   1024 (CUDA events, as in phase 6), ``batches_dispatched``,
   ``rows_padded``, ``busy_seconds``, the card's name and power limit.

10. distributed: ``ShardedTrainer`` (``parallel/tp.py``) on speech through
   ``"pallas"`` on ``[2, 2]`` and ``[1, 2]`` meshes of the one card (the
   FC's weights and accumulator row-sharded over ``model``), 3 steps at
   batch 256 and an update, bit-equal to the replicated ``"pallas"`` and
   ``"xla"`` trainers in outputs, grads and params, one ``qdwconv`` and one
   ``qsoftmax`` launch a cell a step; person_detect_trainable(10) on ``[4, 1]`` (data only)
   with an accumulator at -2**31 + 10, so the serial saturating fold runs
   on the gathered batch, bit-equal to one device and no entry wrapped;
   the two-process tier (``scripts/torch_multiprocess_worker.py``), both
   ranks on ``cuda:0`` under gloo (NCCL needs a card a rank: run only with
   two cards, else printed as not run): ``train_tp`` through ``"pallas"``,
   and one ``infer`` run of sine through ``"pallas"`` and person_detect
   through ``"flat"`` at 2 x 4096 rows (one ``flatpack`` launch a rank);
   each rank exits 0 within 300 s.  Printed, not gated: ms of the sharded speech
   step at batch 1024 on ``[2, 2]`` against the replicated one, in turns,
   with the card's name and power limit; the phase's seconds.

11. residual: MobileNetV2 (``benchmark/configs/mobilenet_v2.tflite``)
   through ``compile_tflite``'s default backend, ``"pallas"`` (the graph
   walk): 36 ``qgemm``, 17 ``qdwconv``, 10 ``qadd`` and 1 ``qsoftmax``
   launches a forward on two requests (batch 1024 and 3), the batch-3
   output bit-equal to ``"xla"`` on the card; each ``qadd`` and the
   ``qsoftmax`` of the batch-1024 forward bit-equal to its plain version
   and timed beside it and its bound; printed, not gated: ``qsoftmax``
   beside the plain op at 2 to 1001 classes.

Then the kernels line, the ``nvidia-smi`` name/power-limit line, and, last,
``{"ok": true, "device": {...}}``.  In the kernels line ``launches`` is the
count from the kernel's main path in phase 4; ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are, for ``qgemm`` and ``qdwconv``, sums
over their 14 launches in one person_detect forward at batch 8192 (per
launch in the ``kernel_times`` line), for ``flatpack``,
``flatpack_fixed``, ``flatpack_raw`` and ``flatpack_noround`` one
person_detect forward at batch 8192 (the last two launched on phase 4's
``MFT_FLAT_REQUANT`` run, their only path), for ``colfc`` one sine
forward at batch 1,048,576, for ``megakernel`` and ``packed`` one launch
on person_detect at batch 8192, for ``qadd`` and ``qsoftmax`` their
launches in one MobileNetV2 forward at batch 1024 (10 and 1; ``launches``
from phase 11's two requests), for ``qwgrad`` its 4 launches in one
person_detect train step at batch 1024 (``launches`` from phase 7's
``"xla"`` step).  No single PyTorch call computes a whole network or a
segment, TFLite's integer ADD, a softmax summed row by row in order or
the normalized fold of per-sample gradients, so those ten kernels have no
``library_ms``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

import microflow_tpu_torch.kernels as kernels
from microflow_tpu_torch import compile_tflite, parse
from microflow_tpu_torch.compiler.ir import (
    AveragePool2DLayer,
    Conv2DLayer,
    DepthwiseConv2DLayer,
    FullyConnectedLayer,
    Graph,
    QuantInfo,
    QuantizeLayer,
    ReshapeLayer,
    SoftmaxLayer,
)
from microflow_tpu_torch.core.activation import FusedActivation, activation_bounds
from microflow_tpu_torch.core.numerics import np_epilogue, np_exact2, np_round_away
from microflow_tpu_torch.core.tensor import ViewGeometry, ViewPadding
from microflow_tpu_torch.kernels import (
    LAUNCHES,
    build,
    build_col_kernel,
    build_flat_kernel,
    build_fused_forward,
    build_packed_kernel,
    colfc_reference,
    flat_forward_reference,
    packed_reference,
)
from microflow_tpu_torch.kernels.flatpack import (
    DW3_S1,
    DW3_S2,
    DW3_STEM,
    dw3_path,
    flat_bound,
    pw_mma,
)
from microflow_tpu_torch.kernels.megakernel import hybrid_split_index
from microflow_tpu_torch.kernels.packed import packed_bound
from microflow_tpu_torch.kernels.qdwconv import (
    PATH_GENERAL,
    PATH_S1,
    PATH_S2,
    PATH_STEM,
    zp_padded,
)
from microflow_tpu_torch.kernels.qdwconv import plan as qdwconv_plan
from microflow_tpu_torch.kernels.qgemm import PATHS as QGEMM_PATHS
from microflow_tpu_torch.kernels.qgemm import qgemm_path
from microflow_tpu_torch.models import (
    GOLDENS,
    model_path,
    person_detect_trainable,
    sine_trainable,
    speech_trainable,
)
from microflow_tpu_torch.ops.depthwise_conv_2d import window_sum
from microflow_tpu_torch.parallel import ShardedTrainer, make_mesh
from microflow_tpu_torch.train import TrainableModel
from microflow_tpu_torch.utils.trace import (
    COUNTERS,
    EAGER_STEPS,
    GRAPH_STEPS,
    WGRAD_FOLDS,
    WGRAD_PLAIN,
)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# int8 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

MODELS = ("sine", "speech", "person_detect")
KERNEL_INFO = {
    "qgemm": {"source": "microflow_tpu_torch/csrc/qgemm.cu",
              "replaces": "microflow_tpu/kernels/qgemm.py:63"},
    "qdwconv": {"source": "microflow_tpu_torch/csrc/qdwconv.cu",
                "replaces": "microflow_tpu/kernels/qdwconv.py:81"},
    "flatpack": {"source": "microflow_tpu_torch/csrc/flatpack.cu",
                 "replaces": "microflow_tpu/kernels/flatpack.py:662"},
    # the flat kernel's requant="fixed" instantiation, flat_kernel<R_FIXED>
    "flatpack_fixed": {"source": "microflow_tpu_torch/csrc/flatpack.cu",
                       "replaces": "microflow_tpu/kernels/flatpack.py:809"},
    # the measurement-only requant modes, flat_kernel<R_RAW> and <R_NOROUND>
    "flatpack_raw": {"source": "microflow_tpu_torch/csrc/flatpack.cu",
                     "replaces": "microflow_tpu/kernels/flatpack.py:784"},
    "flatpack_noround": {"source": "microflow_tpu_torch/csrc/flatpack.cu",
                         "replaces": "microflow_tpu/kernels/flatpack.py:789"},
    "colfc": {"source": "microflow_tpu_torch/csrc/colfc.cu",
              "replaces": "microflow_tpu/kernels/colfc.py:89"},
    "megakernel": {"source": "microflow_tpu_torch/csrc/megakernel.cu",
                   "replaces": "microflow_tpu/kernels/megakernel.py:371"},
    "packed": {"source": "microflow_tpu_torch/csrc/packed.cu",
               "replaces": "microflow_tpu/kernels/packed.py:433"},
    # the JAX package has no ADD
    "qadd": {"source": "microflow_tpu_torch/csrc/qadd.cu", "replaces": None},
    "qsoftmax": {"source": "microflow_tpu_torch/csrc/qsoftmax.cu",
                 "replaces": "microflow_tpu/ops/softmax.py:24"},
    # the JAX package's backward is plain jnp
    "qwgrad": {"source": "microflow_tpu_torch/csrc/qwgrad.cu", "replaces": None},
}
# per-op launches in one person_detect forward
PD_FORWARD = {"qgemm": 14, "qdwconv": 14, "qsoftmax": 1}
# launches of the backward in one person_detect_trainable(10) step on the
# card (layers 22, 24, 26 and 28: its 1x1 convs), whatever the forward's backend
PD_BACKWARD = {"qwgrad": 4}
# person_detect_trainable(10)'s 1x1 convs, whose weight gradients qwgrad folds
PD_POINTWISE = (22, 24, 26, 28)
# H100 SXM: int32 multiply-adds a clock and SM (64 lanes), the boost clock
INT32_MACS_PER_S = 132 * 64 * 1.98e9
# launches of 4 person_detect requests on each megakernel/packed path
PD_PATHS = {"fused": {"megakernel": 4},
            "hybrid": {"megakernel": 4, "qdwconv": 20, "qgemm": 16},  # layers 0-8 per op
            # layers 23-30 per op
            "packed": {"packed": 4, "qdwconv": 8, "qgemm": 12, "qsoftmax": 4}}
MOBILENET = "benchmark/configs/mobilenet_v2.tflite"
# per-op launches in one MobileNetV2 forward (the graph walk of "pallas")
MOBILENET_FORWARD = {"qgemm": 36, "qdwconv": 17, "qadd": 10, "qsoftmax": 1}
ACTS = (FusedActivation.NONE, FusedActivation.RELU, FusedActivation.RELU6)
# qgemm's tensor-core path: every (M, K, N) of these is checked
QGEMM_MMA_EDGES = {"M": (1, 5, 513, 70000), "K": (64, 65, 100, 130, 256, 4000),
                   "N": (2, 4, 11, 16, 129, 250, 256)}
# qgemm's narrow path (K < 64, qgemm_rows): K on and past multiples of 4,
# 8, 16 and 32, N below 16 and on and past multiples of 16 and of the
# 64-column chunk, M not a multiple of a work item
QGEMM_ROWS_EDGES = {"M": (1, 37, 513, 70000), "K": (1, 3, 4, 8, 9, 16, 31, 32, 33, 63),
                    "N": (1, 2, 15, 16, 32, 64, 65)}
# sine's three qgemm shapes, one row a sample: (K, N)
SINE_QGEMM = ((1, 16), (16, 16), (16, 1))
DW_PATHS = {PATH_GENERAL: "general", PATH_S1: "3x3/s1", PATH_S2: "3x3/s2", PATH_STEM: "stem"}
# qdwconv edge cases: (B, H, W, input channels, C, KH, KW, row and column
# strides, padding, centred weights fit int8, in_zp, bytes the input lies
# past an aligned address)
DW_EDGE_CASES = (
    (3, 2, 2, 8, 8, 3, 3, 1, 1, "SAME", True, 99, 0),       # smaller than a strip and a band
    (2, 1, 1, 4, 4, 3, 3, 2, 2, "SAME", True, -128, 0),
    (3, 11, 13, 12, 12, 3, 3, 2, 2, "SAME", True, 45, 0),   # odd sizes at stride 2
    (2, 9, 15, 32, 32, 3, 3, 2, 2, "SAME", True, -128, 0),
    (3, 10, 9, 8, 8, 3, 3, 2, 2, "VALID", True, -1, 0),     # VALID
    (2, 7, 8, 20, 20, 3, 3, 1, 1, "VALID", True, 60, 0),
    (2, 13, 15, 1, 8, 3, 3, 2, 2, "SAME", True, -7, 0),     # the stem at an odd width
    (5, 9, 12, 1, 12, 3, 3, 2, 2, "SAME", True, 3, 0),
    (2, 9, 5, 4, 4, 3, 3, 2, 2, "SAME", True, -60, 0),      # rows of 20 bytes
    (2, 9, 8, 8, 8, 3, 3, 1, 1, "SAME", True, 17, 1),       # an input at an odd address
    (7, 3, 3, 256, 256, 3, 3, 1, 1, "SAME", True, 11, 0),   # several samples a block
    (3, 4, 4, 1024, 1024, 3, 3, 2, 2, "SAME", True, 0, 0),  # 256 channel groups
    (1, 48, 48, 8, 8, 3, 3, 1, 1, "SAME", True, -128, 0),   # batch 1
    (0, 9, 9, 8, 8, 3, 3, 1, 1, "SAME", True, 5, 0),        # batch 0
    # the general path: weights that need i32, C % 4 != 0, speech's 10x8/s2
    # stem, other windows and unequal strides
    (4, 9, 9, 12, 12, 3, 3, 1, 1, "SAME", False, -5, 0),
    (3, 11, 11, 5, 5, 3, 3, 2, 2, "SAME", True, 7, 0),
    (2, 49, 40, 1, 8, 10, 8, 2, 2, "SAME", True, -128, 0),
    (2, 13, 10, 3, 3, 5, 5, 1, 1, "VALID", True, 30, 3),
    (2, 13, 10, 3, 3, 3, 2, 2, 1, "VALID", True, -20, 0),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def flat_requant(mode: str):
    """``MFT_FLAT_REQUANT=mode`` while models are built (the builder reads it
    where it makes the flat kernel, as the JAX package's does)."""
    old = os.environ.get("MFT_FLAT_REQUANT")
    os.environ["MFT_FLAT_REQUANT"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["MFT_FLAT_REQUANT"]
        else:
            os.environ["MFT_FLAT_REQUANT"] = old


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Recorder:
    """Stands in for ``kernels.qgemm``/``kernels.qdwconv`` while a model
    runs, so every call the builder makes is seen with its real inputs.
    ``mode="check"`` launches the kernel and its plain version on the same
    inputs and records the largest difference; ``mode="capture"`` keeps
    the inputs for timing."""

    def __init__(self, mode: str):
        self.mode = mode
        self.calls = {"qgemm": [], "qdwconv": []}
        self._orig = {}

    def __enter__(self):
        for name in self.calls:
            self._orig[name] = getattr(kernels, name)
            setattr(kernels, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(kernels, name, fn)

    def _wrap(self, name):
        def call(*args, **kw):
            out = self._orig[name](*args, **kw)
            if self.mode == "check":
                ref = getattr(kernels, f"{name}_reference")(*args, **kw)
                self.calls[name].append({"shape": _shape(name, args, kw),
                                         "max_abs_err": max_abs_err(out, ref)})
            else:
                self.calls[name].append((args, kw))
            return out

        return call


def _shape(name, args, kw) -> dict:
    if name == "qgemm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return {"M": m, "K": k, "N": n, "act": kw["activation"].value,
                "path": qgemm_path(m, k, n)}
    b, h, w, cin = args[0].shape
    return {"B": b, "H": h, "W": w, "Cin": cin, "C": args[1].shape[2], "kh": kw["kh"],
            "kw": kw["kw"], "sr": kw["sr"], "sc": kw["sc"], "pad": [kw["pad_top"], kw["pad_left"]],
            "act": kw["activation"].value, "path": DW_PATHS[dw_plan(args, kw).path]}


def dw_plan(args, kw):
    """The launch plan ``qdwconv`` takes for these arguments."""
    x = args[0]
    return qdwconv_plan(*x.shape, args[1].shape[2], kh=kw["kh"], kw=kw["kw"], sr=kw["sr"],
                        sc=kw["sc"], pad_top=kw["pad_top"], pad_left=kw["pad_left"], oh=kw["oh"],
                        ow=kw["ow"], int8_taps=kw.get("int8_taps", False),
                        x_align=next(a for a in (16, 4, 1) if x.data_ptr() % a == 0))


def ptxas_usage(log: list) -> dict:
    """``ptxas -v`` lines -> {function: {"registers", "stack", "spill_stores",
    "spill_loads"}} for every entry function."""
    usage, fn = {}, None
    for ln in log:
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            fn = m.group(1)
            usage[fn] = {"registers": 0, "stack": 0, "spill_stores": 0, "spill_loads": 0}
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                    r"(\d+) bytes spill loads", ln)):
            usage[fn].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            usage[fn]["registers"] = int(m[1])
    return usage


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item()) if a.numel() else 0


def random_input(model, batch: int, rng) -> torch.Tensor:
    g = model.graph
    x = rng.integers(-128, 128, (batch, *g.input_shape), dtype=np.int8)
    return torch.from_numpy(x).to(model.device)


# --- edge cases ---------------------------------------------------------------


def fma_hits(q, b0, c1, rnd=np_round_away) -> np.ndarray:
    """Indices where ``b0 + c1*f32(q)`` rounds (by ``rnd``) to another
    integer as one fused multiply-add than as a multiply then an add."""
    sep, fma = np_epilogue(c1, np.asarray(q).astype(np.float32), b0)
    return np.nonzero(rnd(sep) != rnd(fma))[0]


def epilogue_triples(rng, n: int):
    """(q, bias0, c1) triples that stress the epilogue y = bias0 + c1*q:
    y on and within an ulp of +-0.5 and +-k.5, far past the int8 rails,
    and triples where a fused multiply-add would round to another integer
    than a multiply and then an add.  Returns them and the count of the
    last kind."""
    q, b0, c1 = [], [], []
    for k in (-3, -1, 0, 1, 2, 126, -129):  # c1 = 1: y = k + bias0
        for h in (np.float32(0.5), np.float32(-0.5)):
            for b in (h, np.nextafter(h, np.float32(0)), np.nextafter(h, 2 * h)):
                q.append(k)
                b0.append(b)
                c1.append(1.0)
    for qq, bb in ((10**6, 0.0), (-(10**6), 0.0), (0, 1e9), (0, -1e9)):
        q.append(qq)
        b0.append(bb)
        c1.append(0.37)
    # y = +-0.5 exactly where f32(q) is right, for q around 2**22 and past
    # 2**24 (where f32(q) rounds)
    for qq in (2**22 - 1, 2**22, 2**22 + 1, 2**24 + 1, 2**24 + 3, 2**31 - 1):
        for sg in (1, -1):
            t = np.float32(sg * qq) * np.float32(2.0**-20)
            for h in (np.float32(0.5), np.float32(-0.5)):
                b = np.float32(h - t)
                assert np.float32(b + t) == h
                q.append(sg * qq)
                b0.append(b)
                c1.append(2.0**-20)
    m = 4_000_000
    rq = rng.integers(-(2**20), 2**20, m)
    rc = rng.uniform(1e-4, 0.05, m).astype(np.float32)
    rb = rng.uniform(-150.0, 150.0, m).astype(np.float32)
    hit = fma_hits(rq, rb, rc)[:64]
    pick = np.concatenate([hit, rng.integers(0, m, max(0, n - len(q) - len(hit)))])
    q += rq[pick].tolist()
    b0 += rb[pick].tolist()
    c1 += rc[pick].tolist()
    return (np.array(q, np.int64), np.array(b0, np.float32), np.array(c1, np.float32),
            len(hit))


def edge_cases(dev, rng) -> dict:
    errs = {"qgemm": [], "qdwconv": []}

    def check(name, args, kw, label):
        out = getattr(kernels, name)(*args, **kw)
        ref = getattr(kernels, f"{name}_reference")(*args, **kw)
        errs[name].append({"case": label, "max_abs_err": max_abs_err(out, ref)})
        if name == "qgemm":
            errs[name][-1]["path"] = qgemm_path(*args[0].shape, args[1].shape[1])

    i8 = lambda shape: torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    # epilogue: X = 0 makes q = d[n], so each column carries one triple; at
    # K = 4, 8, 16 and 32 on the narrow path (one, two, four and eight words
    # a row), at K = 128 on the tensor cores
    q, b0, c1, n_fma = epilogue_triples(rng, 1024)
    n = len(q)
    for k in (4, 8, 16, 32, 128):
        for act in ACTS:
            kw = dict(activation=act, out_scale=0.05, out_zp=-3)
            check("qgemm", (torch.zeros((5, k), dtype=torch.int8, device=dev),
                            i8((k, n)), i32(np.zeros(n)), i32(q), f32(b0), f32(c1)), kw,
                  f"epilogue K{k} {act.value} ({n_fma} fma-sensitive)")
    # K not a multiple of 4 or 16, per-column w_zp, all activations
    for (M, K, N) in ((5, 37, 11), (300, 1, 16), (77, 5, 33), (64, 4000, 4), (1000, 18, 70),
                      (513, 130, 129)):
        for act in ACTS:
            kw = dict(activation=act, out_scale=float(rng.uniform(0.01, 0.1)),
                      out_zp=int(rng.integers(-20, 20)))
            check("qgemm", (i8((M, K)), i8((K, N)), i32(rng.integers(-9, 9, N)),
                            i32(rng.integers(-5000, 5000, N)), f32(rng.normal(0, 20, N)),
                            f32(rng.uniform(1e-4, 0.01, N))), kw, f"M{M} K{K} N{N} {act.value}")
    # the tensor-core path at its edges: K past multiples of 4, 32 and 64
    # and speech's 4000, N below 4 and past multiples of 16 and 128, M not
    # a multiple of a work item; per-column w_zp in [-9, 9), c1 scaled to
    # K so that few outputs saturate, every activation
    for M in QGEMM_MMA_EDGES["M"]:
        for K in QGEMM_MMA_EDGES["K"]:
            x = i8((M, K))
            for N in QGEMM_MMA_EDGES["N"]:
                args = (x, i8((K, N)), i32(rng.integers(-9, 9, N)),
                        i32(rng.integers(-5000, 5000, N)), f32(rng.normal(0, 20, N)),
                        f32(rng.uniform(0.5, 2.0, N) * 20 / (np.sqrt(K) * 5500)))
                for act in ACTS:
                    kw = dict(activation=act, out_scale=float(rng.uniform(0.01, 0.1)),
                              out_zp=int(rng.integers(-20, 20)))
                    check("qgemm", args, kw, f"M{M} K{K} N{N} {act.value}")
            del x
    # the narrow path at its edges: K on and past multiples of 4, 8, 16 and
    # 32 (byte, word and vector reads), N below 16 and past the 64-column
    # chunk, M not a multiple of a work item, every activation
    for M in QGEMM_ROWS_EDGES["M"]:
        for K in QGEMM_ROWS_EDGES["K"]:
            x = i8((M, K))
            for N in QGEMM_ROWS_EDGES["N"]:
                args = (x, i8((K, N)), i32(rng.integers(-9, 9, N)),
                        i32(rng.integers(-5000, 5000, N)), f32(rng.normal(0, 20, N)),
                        f32(rng.uniform(0.5, 2.0, N) * 20 / (np.sqrt(K) * 5500)))
                for act in ACTS:
                    kw = dict(activation=act, out_scale=float(rng.uniform(0.01, 0.1)),
                              out_zp=int(rng.integers(-20, 20)))
                    check("qgemm", args, kw, f"M{M} K{K} N{N} {act.value}")
            del x
    # X at 1 and 4 bytes past an aligned address (the byte and word reads)
    for (M, K, N, offset) in ((513, 128, 129, 1), (70000, 256, 256, 1), (513, 128, 64, 4),
                              (1000, 100, 16, 1), (77, 64, 8, 4), (513, 8, 16, 1),
                              (70000, 16, 32, 4), (1000, 32, 64, 1), (77, 32, 65, 4),
                              (513, 16, 1, 1), (300, 4, 16, 1), (300, 4, 16, 4)):
        buf = torch.empty(M * K + offset, dtype=torch.int8, device=dev)
        x = buf[offset:].view(M, K)
        x.copy_(i8((M, K)))
        args = (x, i8((K, N)), i32(rng.integers(-9, 9, N)), i32(rng.integers(-5000, 5000, N)),
                f32(rng.normal(0, 20, N)), f32(rng.uniform(0.5, 2.0, N) * 20 / (np.sqrt(K) * 5500)))
        for act in ACTS:
            check("qgemm", args, dict(activation=act, out_scale=0.05, out_zp=-3),
                  f"M{M} K{K} N{N} +{offset} {act.value}")
    # depthwise, unpadded input: the tile paths' edges (smaller than a strip
    # and a band, odd sizes at stride 2, VALID, the stem at an odd width,
    # rows staged in 16-, 4- and 1-byte units, several samples a block, up
    # to 1024 channels), and the general path (C % 4 != 0, the 10x8/s2
    # stem, other windows, weights that need i32); batches 0 and 1; input
    # zero points of -128 and of positive values; every activation
    for (B, H, W, cin, C, kh, kw_, sr, sc, pad, taps, zp, offset) in DW_EDGE_CASES:
        geom = (ViewGeometry(H, W, kh, kw_, -(-H // sr), -(-W // sc), sr, sc, ViewPadding.SAME)
                if pad == "SAME" else ViewGeometry(H, W, kh, kw_, (H - kh) // sr + 1,
                                                   (W - kw_) // sc + 1, sr, sc, ViewPadding.VALID))
        top, _, left, _ = geom.pad_amounts()
        for act in ACTS:
            xn = rng.integers(-128, 128, (B, H, W, cin), dtype=np.int8)
            if xn.size >= 2:
                xn.flat[:2] = (-128, 127)
            buf = torch.empty(xn.size + offset, dtype=torch.int8, device=dev)
            x = buf[offset:].view(xn.shape)  # the input at ``offset`` bytes from an aligned one
            x.copy_(torch.from_numpy(xn))
            w = rng.integers(-128, 128, (kh, kw_, C))
            w[0, 0, 0::2], w[-1, -1, 1::2] = -128, 127
            wc = w - (0 if taps else rng.integers(-9, 10, C))
            kw = dict(in_zp=zp, pad_top=top, pad_left=left, kh=kh, kw=kw_, sr=sr, sc=sc,
                      oh=geom.out_rows, ow=geom.out_cols, activation=act,
                      out_scale=float(rng.uniform(0.01, 0.1)), out_zp=int(rng.integers(-20, 20)),
                      int8_taps=taps)
            args = (x, i32(wc), i32(-zp * wc.sum(axis=(0, 1))), f32(rng.normal(0, 20, C)),
                    f32(rng.uniform(1e-3, 5e-3, C)))
            check("qdwconv", args, kw, f"B{B} {H}x{W}x{cin}->{C} {kh}x{kw_}/({sr},{sc}) {pad} "
                  f"zp{zp} +{offset} {DW_PATHS[dw_plan(args, kw).path]} {act.value}")
    return errs


def _fc(index: int, w: np.ndarray, bias0, c1: float, act: FusedActivation,
        out_scale: float) -> FullyConnectedLayer:
    """A FullyConnected layer of the port's IR with all zero points 0, so
    ``acc = sum x*w`` and ``y = bias0 + c1*f32(acc)``."""
    q = lambda s: QuantInfo(np.array([s], np.float32), np.zeros(1, np.int64))
    n = w.shape[1]
    return FullyConnectedLayer(
        index=index, weights=w.astype(np.int8), in_q=q(1.0), w_q=q(1.0), bias_q=q(1.0),
        out_q=q(out_scale), c0=np.asarray(bias0, np.float32), c1=np.float32(c1),
        c2=np.zeros(n, np.int32), c3=0, activation=act, flatten_input=False, out_shape=(n,))


def edge_graph(name, w_row, bias0, c1: float, act=FusedActivation.NONE,
               out_scale: float = 0.05) -> Graph:
    """int8 [B, 1] -> FC 1->1 (y = x exactly) -> FC 1->N with weights
    ``w_row`` and epilogue constants ``bias0``, ``c1``: lane n of a sample
    with input x computes y = bias0[n] + c1*f32(x * w_row[n]).  Both
    whole-network kernels take it."""
    q = QuantInfo(np.array([1.0], np.float32), np.zeros(1, np.int64))
    n = len(w_row)
    layers = [_fc(0, np.ones((1, 1)), [0.0], 1.0, FusedActivation.NONE, 1.0),
              _fc(1, np.asarray(w_row).reshape(1, n), bias0, c1, act, out_scale)]
    return Graph(name=name, layers=layers, input_shape=(1,), input_q=q,
                 input_dtype=np.dtype(np.int8), output_shape=(n,), output_q=q,
                 output_dtype=np.dtype(np.int8))


# colfc's fabricated chains: (name, K0, output widths, activations, input
# zero point, per-channel c1).  Widths 3, 5, 7, 9, 31 and 32 (n-tiles 1-4,
# odd ones and full ones), K0 = 32 and 17, five layers, RELU with a
# positive out_zp (it lifts the padded columns, which the next layer's
# zero rows of W must cancel), N_out 1 (bytes) and even (pairs)
COL_CHAINS = (
    ("col_3_5_7", 3, (5, 7, 3), ("NONE", "RELU", "RELU6"), 19, True),
    ("col_k32", 32, (32, 32), ("RELU", "NONE"), -128, True),
    ("col_5_layers", 4, (16, 32, 8, 24, 2), ("RELU", "NONE", "RELU6", "RELU", "NONE"), 77, True),
    ("col_odd", 17, (9, 31, 1), ("NONE", "RELU6", "NONE"), -3, False),
    ("col_relu_lift", 8, (5, 3), ("RELU", "RELU"), 127, True),
)


def col_chain_graph(rng, name: str, k0: int, widths, acts, in_zp: int,
                    per_channel: bool) -> Graph:
    """int8 [B, K0] -> a chain of FullyConnected layers of the port's IR:
    uniform int8 weights (w_zp 0), the input zero point ``in_zp`` and each
    later layer's that of the layer before; out_zp in [1, 40] after a RELU
    or RELU6, else in [-20, 20]; c1 per channel (``per_channel``) or one,
    scaled so that y spreads over the int8 range."""
    def q(scale, zp):
        return QuantInfo(np.array([scale], np.float32), np.array([zp], np.int64))

    layers, k, zp = [], k0, in_zp
    for i, (n, act) in enumerate(zip(widths, acts)):
        act = FusedActivation[act]
        out_zp = int(rng.integers(1, 41) if act is not FusedActivation.NONE
                     else rng.integers(-20, 21))
        scale = 40.0 / (74.0 * 74.0 * np.sqrt(k))
        c1 = (rng.uniform(0.3, 1.5, n) if per_channel else rng.uniform(0.3, 1.5)) * scale
        layers.append(FullyConnectedLayer(
            index=i, weights=rng.integers(-128, 128, (k, n), dtype=np.int8), in_q=q(0.05, zp),
            w_q=q(0.02, 0), bias_q=q(0.001, 0), out_q=q(0.1, out_zp),
            c0=rng.normal(0.0, 20.0, n).astype(np.float32),
            c1=np.asarray(c1, np.float32) if per_channel else np.float32(c1),
            c2=np.zeros(n, np.int32), c3=0, activation=act, flatten_input=False,
            out_shape=(n,)))
        k, zp = n, out_zp
    return Graph(name=name, layers=layers, input_shape=(k0,), input_q=q(0.05, in_zp),
                 input_dtype=np.dtype(np.int8), output_shape=(k,), output_q=q(0.1, zp),
                 output_dtype=np.dtype(np.int8))


def edge_graphs(rng) -> tuple[list, int]:
    """The epilogue edge graphs and the count of FMA-sensitive lanes.  With
    c1 = 1 (y = b0 + x*w): the b0 of ``epilogue_triples``'s first block
    (+-0.5 and the ulps around it) on w = 1 lanes put y on every +-k.5 and
    its neighbours as x sweeps int8, and on w = 0 lanes on the ``exact2``
    corners +-(0.5 - 2**-25) themselves; w = 127 and -128 lanes and b0 =
    +-1e9 go past both rails; once with no activation and once with RELU6
    (clip to [0, 60]).  With a fixed c1 = 0.37: lanes (w, b0) on which some
    int8 x gives a triple that an FMA would round otherwise."""
    q, b0, c1, _ = epilogue_triples(rng, 0)
    halves = sorted(set(b0[(c1 == 1.0)].tolist()))
    w_row = [1] * len(halves) + [0] * len(halves) + [127, -128, 0, 0, 127, -128]
    bias = halves + halves + [0.0, 0.0, 1e9, -1e9, 0.25, -0.25]
    graphs = [edge_graph("edge_c1_one", w_row, bias, 1.0),
              edge_graph("edge_c1_one_relu6", w_row, bias, 1.0, FusedActivation.RELU6, 0.1)]
    c1_fixed = np.float32(0.37)
    m = 4_000_000
    x = rng.integers(-128, 128, m)
    w = rng.integers(-128, 128, m)
    b = rng.uniform(-150.0, 150.0, m).astype(np.float32)
    hit = fma_hits(x * w, b, np.full(m, c1_fixed), np_exact2)[:32]
    graphs.append(edge_graph("edge_fma", w[hit].tolist(), b[hit].tolist(), float(c1_fixed)))
    return graphs, len(hit)


def noround_edge_graph() -> Graph:
    """``noround`` at its edges (``edge_graph`` under RELU6, clip [0, 60] at
    out_scale 0.1, c1 = 1): lane n computes y = bias0[n] + x * w[n]; as x
    sweeps int8, lanes with w = 127 and -128 and with bias0 = +-200.75 pass
    both int8 rails (noround saturates there), lanes with w = 1 run through
    and past the RELU6 bounds, which noround does not apply, and the
    bias0 of +-0.75, 0.25 and 59.5 put y on halves, which it truncates
    toward zero."""
    return edge_graph("noround_edge", [1, 1, 1, 1, 127, -128, 0, 0],
                      [-0.75, 0.25, 59.5, 0.75, 0.0, 0.0, 200.75, -200.75], 1.0,
                      FusedActivation.RELU6, 0.1)


def raw_edge_graph() -> Graph:
    """``raw`` at its edges (``edge_graph``): lane n's accumulator is x * w[n],
    which for w in {127, -128, 64, 3} leaves int8 as x sweeps it; raw keeps
    its low byte."""
    return edge_graph("raw_edge", [1, 127, -128, 64, 3, -1, 0, 2], [0.5] * 8, 0.5)


def mode_edge_counts(g: Graph, sweep: np.ndarray) -> dict:
    """What an edge graph's second layer meets on inputs ``sweep``, over
    (sample, lane): accumulators outside int8, and y = bias0 + c1 * acc past
    an int8 rail, or truncated to a value outside the layer's activation
    bounds within int8."""
    layer = g.layers[1]
    acc = sweep.astype(np.int64)[:, None] * layer.weights[0].astype(np.int64)[None, :]
    y = np_epilogue(np.float32(layer.c1), acc.astype(np.float32),
                    np.float32(layer.out_q.zp0) + layer.c0)[0]
    lo, hi = activation_bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0)
    t = np.trunc(y)
    inside = (t >= -128) & (t <= 127)
    return {"acc_outside_int8": int(((acc < -128) | (acc > 127)).sum()),
            "y_past_rails": int((~inside).sum()),
            "y_outside_activation_bounds": int((inside & ((t < lo) | (t > hi))).sum())}


def fixed_target(p: float):
    """``(M, S, q)``, M in [2**14, 2**15) and |q| < 2**22, for which the
    fixed epilogue's ``f32(q) * (M * 2**-S)`` is exactly ``p``; None if
    there is none below S = 44."""
    ms = np.arange(1 << 14, 1 << 15, dtype=np.int64)
    for shift in range(15, 44):
        n = p * 2.0**shift
        if n != int(n):
            continue
        for m in ms[(abs(int(n)) % ms) == 0]:
            q = int(n) // int(m)
            if abs(q) < 1 << 22:
                return int(m), shift, q
    return None


FIXED_EDGE_ACTS = ((FusedActivation.NONE, -7, 0.05), (FusedActivation.RELU, -3, 0.05),
                   (FusedActivation.RELU6, 5, 0.1))  # (activation, out_zp, out_scale)


def fixed_edge_graph(act: FusedActivation, out_zp: int, out_scale: float) -> Graph:
    """The fixed-point epilogue at its edges, on the flat kernel's
    tensor-core path: int8 [1, 1, 4] -> a 1x1 conv 4 -> 4 that passes the
    input through (m = 1, bias_q = 0) -> a 1x1 conv 4 -> N with per-channel
    constants, whose lane n computes ``q = x * w[n] + bias_q[n]`` from the
    first input channel x and ``p = f32(q) * m[n]``.  Lanes with w = 1 put
    p, at x = 0, exactly on +-(k + 0.5) and on the one and two ulps around
    it (k = 0, 1, 2, 5, 17, 63, 126, by ``fixed_target``; 0.5 - 2**-25
    among them), and as x sweeps int8 on their neighbours; lanes with m =
    0.5 put p on every +-(k + 0.5) as x sweeps and past both rails (bias_q
    = +-300, w = 127 and -128); lanes with m = 2**-18 carry q past +-2**24,
    where f32(q) rounds.  ``out_zp`` lands after the rounding."""
    f32 = np.float32
    lanes = []  # (w, M, S, bias_q)
    for k in (0, 1, 2, 5, 17, 63, 126):
        h = f32(k + 0.5)
        below = np.nextafter(h, f32(0))
        above = np.nextafter(h, f32(1e9))
        for v in (h, below, above, np.nextafter(below, f32(0)), np.nextafter(above, f32(1e9))):
            for sign in (1, -1):
                hit = fixed_target(float(v) * sign)
                if hit is not None:
                    lanes.append((1, *hit))
    for b in (0, 1, 300, -300):
        lanes.append((1, 1 << 14, 15, b))
    for w in (127, -128):
        lanes.append((w, 1 << 14, 15, 0))
    for b in (2**24 + 2**17, -(2**24 + 2**17), 3 * 2**23 + 2**17 + 1, -(2**24 - 40)):
        lanes.append((1, 1 << 14, 32, b))
    n = -(-len(lanes) // 16) * 16  # a multiple of 16: the tensor-core path
    lanes += [(1, 1 << 14, 15, 0)] * (n - len(lanes))
    w, m, shift, bias_q = (np.array(v, np.int64) for v in zip(*lanes))
    c1 = (m * np.exp2(-shift.astype(np.float64))).astype(f32)
    c0 = (bias_q * c1.astype(np.float64)).astype(f32)  # round(c0 / c1) = bias_q
    unit = lambda zp, scale=1.0: QuantInfo(np.array([scale], f32), np.array([zp], np.int64))
    g1 = ViewGeometry(1, 1, 1, 1, 1, 1, 1, 1, ViewPadding.VALID)
    eye = np.eye(4, dtype=np.int8).reshape(4, 1, 1, 4)
    f = np.zeros((n, 1, 1, 4), np.int8)
    f[:, 0, 0, 0] = w
    layers = [
        Conv2DLayer(0, eye, unit(0), unit(0), unit(0), unit(0), np.zeros(4, f32),
                    np.ones(4, f32), g1, FusedActivation.NONE, (1, 1, 4)),
        Conv2DLayer(1, f, unit(0), unit(0), unit(0), unit(out_zp, out_scale), c0, c1, g1, act,
                    (1, 1, n))]
    return Graph(name=f"fixed_edge_{act.value}", layers=layers, input_shape=(1, 1, 4),
                 input_q=unit(0), input_dtype=np.dtype(np.int8), output_shape=(1, 1, n),
                 output_q=unit(out_zp, out_scale), output_dtype=np.dtype(np.int8))


def fixed_edge_counts(op, x0: np.ndarray) -> dict:
    """What a fixed edge graph's second op meets on first input channels
    ``x0``, counted over (sample, lane): p exactly on +-(k + 0.5), p within
    two ulps of one and not on it, outputs past a rail, and q that f32
    rounds."""
    f32 = np.float32
    q = x0.astype(np.int64)[:, None] * op.weights[:, 0, 0, 0].astype(np.int64) + op.bias_q
    p = (q.astype(f32) * op.m).astype(f32)
    half = (np.floor(p.astype(np.float64)) + 0.5).astype(f32)
    gap = np.abs(p.view(np.int32).astype(np.int64) - half.view(np.int32).astype(np.int64))
    t = np.trunc((p + np.where(p >= 0, f32(0.5), f32(-0.5))).astype(f32)) + op.out_zp
    return {"ties": int((p == half).sum()), "near_ties": int(((gap > 0) & (gap <= 2)).sum()),
            "past_rails": int(((t < op.clip_lo) | (t > op.clip_hi)).sum()),
            "q_rounded_to_f32": int((q.astype(f32).astype(np.int64) != q).sum())}


def exact2_corners(g: Graph, sweep: np.ndarray) -> int:
    """How many (sample, lane) outputs of an edge graph on inputs ``sweep``
    sit on an ``exact2`` corner: ``exact2`` and round-half-away give other
    int8 values for ``y = bias0 + c1*f32(x*w)`` (the megakernel must round
    half away there)."""
    layer = g.layers[1]
    q = sweep.astype(np.int64)[:, None] * layer.weights.astype(np.int64)  # [S, N]
    bias0 = np.float32(layer.out_q.zp0) + layer.c0.astype(np.float32)
    y, _ = np_epilogue(np.float32(layer.c1), q.astype(np.float32), bias0[None, :])
    lo, hi = activation_bounds(layer.activation, layer.out_q.scale0, layer.out_q.zp0)
    return int((np.clip(np_exact2(y), lo, hi) != np.clip(np_round_away(y), lo, hi)).sum())


def conv_graph(rng, wzp: bool = False) -> Graph:
    """A small conv graph of the port's IR, random weights, whose ops take
    the flat kernel's general paths, which the bundled models do not
    reach: a depth-multiplier stem to 6 channels, a 3x3/s2 Conv2D over 6
    channels, depthwise convs over 5 channels, a 1x1 conv over 5 channels
    and one to 6 outputs, a padded 2x2 pool, FC and softmax over 7; also a
    depthwise conv on the 3x3 path and a 1x1 conv on ``__dp4a``.  With ``wzp`` (the
    megakernel's variant): a leading int8 QuantizeLayer, and nonzero
    per-channel weight zero points on the 3x3/s2 conv, the 3x3 depthwise
    conv after it and the 1x1 conv to 12, and a nonzero one on the FC."""
    q = lambda zp: QuantInfo(np.array([rng.uniform(0.01, 0.1)], np.float32),
                             np.array([zp], np.int64))
    zps = iter(rng.integers(-128, 100, 16).tolist())
    acts = (FusedActivation.NONE, FusedActivation.RELU, FusedActivation.RELU6)
    layers, shape, in_q = [], (13, 11, 1), q(-5)
    input_q = in_q

    def geom(k, s, pad):
        h, w = shape[:2]
        oh, ow = ((-(-h // s), -(-w // s)) if pad is ViewPadding.SAME
                  else ((h - k) // s + 1, (w - k) // s + 1))
        return ViewGeometry(h, w, k, k, oh, ow, s, s, pad)

    def w_q(n, nonzero):
        zp = rng.choice([-9, -4, -1, 1, 3, 8], n) if nonzero else np.zeros(1, np.int64)
        return QuantInfo(np.ones(len(zp), np.float32), np.asarray(zp, np.int64))

    def add(kind, *spec, nonzero=False):
        nonlocal shape, in_q
        i = len(layers)
        out_q = q(next(zps))
        act = acts[i % 3]
        if kind in ("conv", "dw"):
            k, s, c_out = spec
            g = geom(k, s, ViewPadding.SAME)
            c1 = rng.uniform(1e-3, 1e-2, c_out).astype(np.float32)
            c0 = rng.normal(0, 20, c_out).astype(np.float32)
            wq = w_q(c_out, nonzero)
            if kind == "conv":
                f = rng.integers(-127, 128, (c_out, k, k, shape[2])).astype(np.int8)
                layers.append(Conv2DLayer(i, f, in_q, wq, wq, out_q, c0, c1, g, act,
                                          (g.out_rows, g.out_cols, c_out)))
            else:
                w = rng.integers(-127, 128, (k, k, c_out)).astype(np.int8)
                layers.append(DepthwiseConv2DLayer(i, w, in_q, wq, wq, out_q, c0, c1, g,
                                                   act, (g.out_rows, g.out_cols, c_out)))
            shape = (g.out_rows, g.out_cols, c_out)
        elif kind == "quantize":
            layers.append(QuantizeLayer(i, in_q, out_q, np.dtype(np.int8), shape))
        elif kind == "pool":
            g = geom(2, 2, ViewPadding.SAME)
            layers.append(AveragePool2DLayer(i, in_q, out_q, np.float32(0.9), np.float32(3.0),
                                             g, act, (g.out_rows, g.out_cols, shape[2])))
            shape = (g.out_rows, g.out_cols, shape[2])
        elif kind == "reshape":
            shape = (int(np.prod(shape)),)
            layers.append(ReshapeLayer(i, shape, in_q))
            out_q = in_q
        elif kind == "fc":
            (n,) = spec
            w = rng.integers(-127, 128, (shape[0], n)).astype(np.int8)
            wq = w_q(1, nonzero)
            # the reference's fold: c2 = in_zp * colsum(W), c3 = K * in_zp * w_zp
            layers.append(FullyConnectedLayer(
                i, w, in_q, wq, in_q, out_q, rng.normal(0, 20, n).astype(np.float32),
                np.float32(2e-3), (in_q.zp0 * w.astype(np.int64).sum(0)).astype(np.int32),
                shape[0] * in_q.zp0 * wq.zp0, act, False, (n,)))
            shape = (n,)
        else:
            layers.append(SoftmaxLayer(i, in_q, q(-128), shape))
            out_q = layers[-1].out_q
        in_q = out_q

    if wzp:
        add("quantize")
    for pos, spec in enumerate((("dw", 3, 1, 6), ("conv", 3, 2, 5), ("dw", 3, 1, 5),
                                ("dw", 3, 2, 5), ("conv", 1, 1, 8), ("dw", 3, 1, 8),
                                ("conv", 1, 1, 12), ("conv", 1, 1, 6), ("pool",), ("reshape",),
                                ("fc", 7), ("softmax",))):
        add(*spec, nonzero=wzp and pos in (1, 2, 6, 10))
    return Graph(name="conv_graph_wzp" if wzp else "conv_graph", layers=layers,
                 input_shape=(13, 11, 1), input_q=input_q, input_dtype=np.dtype(np.int8),
                 output_shape=shape, output_q=in_q, output_dtype=np.dtype(np.int8))


PW_EDGE = (("pw", 16, 1), ("pw", 8, 1), ("pw", 48, 2), ("pw", 20, 1), ("pw", 256, 1), ("dw", 5),
           ("pw", 96, 1), ("pw", 256, 1), ("dw", 3), ("pw", 16, 1), ("pool", 7), ("pw", 48, 1),
           ("pw", 256, 1))
PW_EDGE_MMA = [0, 2, 4, 6, 7, 9, 11, 12]  # its layers on the flat kernel's tensor-core path


def pw_edge_graph(rng) -> Graph:
    """A chain of 1x1 convs of the port's IR at the edges of the flat
    kernel's tensor-core path, int8 [25, 1, 4] in.  Its tensor-core convs
    (layers ``PW_EDGE_MMA``), input -> output channels on so many output
    pixels: 4 -> 16 on 25; 8 -> 48 with stride 2 (25 -> 13 rows); 20 ->
    256 on 13; 256 -> 96 and 96 -> 256 on 9; 256 -> 16 on 7; 16 -> 48 and
    48 -> 256 on 1.  5x1 and 3x1 VALID depthwise convs and a 7x1 pool
    shrink the column, and 1x1 convs to 8 and 20 channels take the
    ``__dp4a`` path in between.  Random weights, every filter holding -128
    or 127, nonzero input zero points, every activation (RELU6 on every
    third layer)."""
    q = lambda: QuantInfo(np.array([rng.uniform(0.02, 0.1)], np.float32),
                          np.array([rng.choice([-100, -37, -1, 1, 45, 99])], np.int64))
    w_q = QuantInfo(np.ones(1, np.float32), np.zeros(1, np.int64))
    layers, shape, in_q = [], (25, 1, 4), q()
    input_q = in_q
    for i, (kind, *spec) in enumerate(PW_EDGE):
        out_q, act = q(), ACTS[i % 3]
        h, w, c_in = shape
        if kind == "pw":
            c_out, s = spec
            g = ViewGeometry(h, w, 1, 1, (h - 1) // s + 1, (w - 1) // s + 1, s, s,
                             ViewPadding.VALID)
            f = rng.integers(-128, 128, (c_out, 1, 1, c_in)).astype(np.int8)
            f[0::2, 0, 0, 0], f[1::2, 0, 0, -1] = -128, 127
            c1 = (rng.uniform(0.5, 1.5, c_out) * 40 / (np.sqrt(c_in) * 5476)).astype(np.float32)
            layers.append(Conv2DLayer(i, f, in_q, w_q, w_q, out_q,
                                      rng.normal(0, 20, c_out).astype(np.float32), c1, g, act,
                                      (g.out_rows, g.out_cols, c_out)))
        elif kind == "dw":
            (k,) = spec
            g = ViewGeometry(h, w, k, 1, h - k + 1, w, 1, 1, ViewPadding.VALID)
            wd = rng.integers(-128, 128, (k, 1, c_in)).astype(np.int8)
            layers.append(DepthwiseConv2DLayer(
                i, wd, in_q, w_q, w_q, out_q, rng.normal(0, 20, c_in).astype(np.float32),
                rng.uniform(1e-3, 5e-3, c_in).astype(np.float32), g, act,
                (g.out_rows, g.out_cols, c_in)))
        else:
            (k,) = spec
            g = ViewGeometry(h, w, k, 1, h - k + 1, w, 1, 1, ViewPadding.VALID)
            layers.append(AveragePool2DLayer(i, in_q, out_q, np.float32(0.9), np.float32(3.0), g,
                                             act, (g.out_rows, g.out_cols, c_in)))
        shape, in_q = layers[-1].out_shape, out_q
    return Graph(name="pw_edge_graph", layers=layers, input_shape=(25, 1, 4), input_q=input_q,
                 input_dtype=np.dtype(np.int8), output_shape=shape, output_q=in_q,
                 output_dtype=np.dtype(np.int8))


DW_EDGE = (("dw", 2, "SAME", 8), ("dw", 1, "SAME", 8), ("dw", 2, "SAME", 8), ("pw", 4),
           ("dw", 1, "VALID", 4), ("dw", 2, "VALID", 4), ("pw", 256), ("dw", 1, "SAME", 256),
           ("dw", 2, "SAME", 256), ("dw", 1, "VALID", 256))
DW_EDGE_ZP = (45, -128, 99, -128, 17, -128, 3, -128, 60, -128, 11)  # input zero point of each layer
# the path of each of its depthwise layers in the flat kernel: all take the 3x3 path
DW_EDGE_DW3 = {0: DW3_STEM, 1: DW3_S1, 2: DW3_S2, 4: DW3_S1, 5: DW3_S2, 7: DW3_S1, 8: DW3_S2,
               9: DW3_S1}
# the megakernel's path of each op of dw_edge_graph(wzp=True): the strips
# wherever the centred taps fit int8, op_dw for the last layer, op_pw for
# the 1x1 convs with weight zero points
DW_EDGE_WZP_PATHS = ["dw3_stem", "dw3_s1", "dw3_s2", "pw", "dw3_s1", "dw3_s2", "pw", "dw3_s1",
                     "dw3_s2", "dw"]


def dw_edge_graph(rng, wzp: bool = False) -> Graph:
    """A chain of 3x3 depthwise convs of the port's IR at the edges of the
    flat kernel's 3x3 path, int8 [61, 52, 1] in: the IC = 1 stride-2 stem
    to 8 channels (26 output columns, a partial strip of 4), then at 8
    channels SAME stride 1 and stride 2 (26 -> 13 columns), a 1x1 conv to 4,
    VALID stride 1 (13 -> 11) and VALID stride 2 on the odd width (-> 5), a
    1x1 conv to 256, SAME stride 1, SAME stride 2 on the odd width (-> 3)
    and VALID stride 1 (-> 1x1).  Widths that are not a multiple of the
    strip of 3, input zero points of -128 and of positive values
    (``DW_EDGE_ZP``), random weights holding -128 and 127, every activation
    (RELU6 on every third layer).  With ``wzp`` (the megakernel's variant):
    nonzero per-channel weight zero points on every layer; the depthwise
    taps drawn so that the centred taps ``w - w_zp`` fit int8 and reach
    -128 and 127, except in the last layer, where they reach -255 and 255
    (``DW_EDGE_WZP_PATHS``)."""
    q = lambda zp: QuantInfo(np.array([rng.uniform(0.02, 0.1)], np.float32),
                             np.array([zp], np.int64))
    w_q = QuantInfo(np.ones(1, np.float32), np.zeros(1, np.int64))
    layers, shape, in_q = [], (61, 52, 1), q(DW_EDGE_ZP[0])
    input_q = in_q
    for i, (kind, *spec) in enumerate(DW_EDGE):
        out_q, act = q(DW_EDGE_ZP[i + 1]), ACTS[i % 3]
        h, w, c_in = shape
        c0 = rng.normal(0, 20, spec[-1]).astype(np.float32)
        if wzp:
            zp = rng.choice([-9, -4, -1, 1, 3, 8], spec[-1])
            w_q = QuantInfo(np.ones(len(zp), np.float32), zp.astype(np.int64))
        if kind == "pw":
            (c_out,) = spec
            g = ViewGeometry(h, w, 1, 1, h, w, 1, 1, ViewPadding.VALID)
            f = rng.integers(-128, 128, (c_out, 1, 1, c_in)).astype(np.int8)
            c1 = (rng.uniform(0.5, 1.5, c_out) * 40 / (np.sqrt(c_in) * 5476)).astype(np.float32)
            layers.append(Conv2DLayer(i, f, in_q, w_q, w_q, out_q, c0, c1, g, act,
                                      (h, w, c_out)))
        else:
            s, pad, c_out = spec
            if pad == "SAME":
                g = ViewGeometry(h, w, 3, 3, -(-h // s), -(-w // s), s, s, ViewPadding.SAME)
            else:
                g = ViewGeometry(h, w, 3, 3, (h - 3) // s + 1, (w - 3) // s + 1, s, s,
                                 ViewPadding.VALID)
            if wzp:  # centred taps in [-128, 127]: -128 where w_zp > 0, 127 where < 0
                wd = rng.integers(np.maximum(-128, zp - 128), np.minimum(127, zp + 127) + 1,
                                  (3, 3, c_out))
                wd[0, 0, zp > 0], wd[2, 2, zp < 0] = zp[zp > 0] - 128, zp[zp < 0] + 127
                if i == len(DW_EDGE) - 1:  # centred taps of 255 and -255
                    w_q.zero_point[:2] = (-128, 127)
                    wd[1, 1, :2] = (127, -128)
                wd = wd.astype(np.int8)
            else:
                wd = rng.integers(-128, 128, (3, 3, c_out)).astype(np.int8)
                wd[0, 0, 0::2], wd[2, 2, 1::2] = -128, 127
            layers.append(DepthwiseConv2DLayer(
                i, wd, in_q, w_q, w_q, out_q, c0, rng.uniform(1e-3, 5e-3, c_out).astype(np.float32),
                g, act, (g.out_rows, g.out_cols, c_out)))
        shape, in_q = layers[-1].out_shape, out_q
    return Graph(name="dw_edge_graph_wzp" if wzp else "dw_edge_graph", layers=layers,
                 input_shape=(61, 52, 1), input_q=input_q, input_dtype=np.dtype(np.int8),
                 output_shape=shape, output_q=in_q, output_dtype=np.dtype(np.int8))


def packed_graph(rng) -> Graph:
    """A small graph of the port's IR that the packed kernel takes whole:
    int8 [16, 32, 1] -> a 3x3/s2 stem to 16 channels, a 3x3 depthwise conv,
    a 1x1 conv to 32, a 3x3/s2 depthwise conv, a 1x1 conv 32 -> 32, a 3x3
    depthwise conv and a 1x1 conv to 16: [4, 8, 16].  Random weights and
    zero points, every activation."""
    q = lambda: QuantInfo(np.array([rng.uniform(0.01, 0.1)], np.float32),
                          np.array([int(rng.integers(-128, 100))], np.int64))
    w_q = QuantInfo(np.ones(1, np.float32), np.zeros(1, np.int64))
    acts = (FusedActivation.NONE, FusedActivation.RELU, FusedActivation.RELU6)
    layers, shape, in_q = [], (16, 32, 1), q()
    input_q = in_q
    for i, (kind, s, c_out) in enumerate((("dw", 2, 16), ("dw", 1, 16), ("pw", 1, 32),
                                          ("dw", 2, 32), ("pw", 1, 32), ("dw", 1, 32),
                                          ("pw", 1, 16))):
        k = 3 if kind == "dw" else 1
        h, w = shape[:2]
        g = ViewGeometry(h, w, k, k, -(-h // s), -(-w // s), s, s, ViewPadding.SAME)
        out_q, act = q(), acts[i % 3]
        c0 = rng.normal(0, 20, c_out).astype(np.float32)
        if kind == "dw":
            c1 = rng.uniform(1e-3, 1e-2, c_out).astype(np.float32)
            w = rng.integers(-127, 128, (3, 3, c_out)).astype(np.int8)
            layers.append(DepthwiseConv2DLayer(i, w, in_q, w_q, w_q, out_q, c0, c1, g, act,
                                               (g.out_rows, g.out_cols, c_out)))
        else:
            c1 = rng.uniform(5e-4, 5e-3, c_out).astype(np.float32)
            f = rng.integers(-127, 128, (c_out, 1, 1, shape[2])).astype(np.int8)
            layers.append(Conv2DLayer(i, f, in_q, w_q, w_q, out_q, c0, c1, g, act,
                                      (g.out_rows, g.out_cols, c_out)))
        shape, in_q = (g.out_rows, g.out_cols, c_out), out_q
    return Graph(name="packed_graph", layers=layers, input_shape=(16, 32, 1), input_q=input_q,
                 input_dtype=np.dtype(np.int8), output_shape=shape, output_q=in_q,
                 output_dtype=np.dtype(np.int8))


# packed_edge_graph's layers: (kind, row and column stride, output channels)
PACKED_EDGE = (("dw", (2, 2), 2), ("dw", (1, 1), 2), ("pw", (1, 1), 8), ("pw", (1, 1), 4),
               ("dw", (1, 2), 4), ("pw", (1, 1), 32), ("pw", (1, 1), 2), ("pw", (1, 1), 16),
               ("dw", (1, 1), 16), ("dw", (2, 2), 16), ("pw", (1, 1), 32))
# the packed kernel's path of each of its ops: every general path (op_dw
# from one input channel and from as many as it has, op_conv, op_pw to 4
# and to 2 channels) and op_dw_vec, between strips and tensor-core convs
PACKED_EDGE_PATHS = ["dw", "dw", "conv", "pw", "dw_vec", "pw_mma", "pw", "conv", "dw3_s1",
                     "dw3_s2", "pw_mma"]
PACKED_EDGE_CORNERS = 10  # the 1x1 conv whose epilogue constants sit on the corners


def packed_edge_graph(rng) -> Graph:
    """A graph of the port's IR that ``plan_packed`` takes whole and whose
    ops reach each path of the packed kernel (``PACKED_EDGE_PATHS``), int8
    [13, 256, 1] in: a 3x3/s2 stem to 2 channels and a 3x3 depthwise conv
    over them at 128 columns (256 lanes), 1x1 convs from 2 channels and to
    4 and 2, a 3x3 depthwise conv at row stride 1 and column stride 2, and
    strips and tensor-core convs between them: [4, 32, 32] out.  Random
    weights and zero points (-128 at the input), every activation; each
    layer's c0 and c1 are set from its accumulators on 4 random samples so
    that its outputs spread over the int8 range.  The last layer
    (``PACKED_EDGE_CORNERS``, 16 -> 32 on the tensor cores, no activation,
    output zero point 0, so bias0 = c0) has c1 = 1 on 16 lanes: lanes of
    weights 1 put y = c0 + the sum of (x - in_zp) over its input channels
    on every +-k.5 and the ulps around it as the input varies; lanes of
    weights 0 put y on c0 itself, +-0.5 and the ulps around it,
    +-(0.5 - 2**-25) among them; lanes of weights 127 and -128 and c0 =
    +-1e9 go past both rails."""
    q = lambda zp: QuantInfo(np.array([rng.uniform(0.02, 0.1)], np.float32),
                             np.array([zp], np.int64))
    w_q = QuantInfo(np.ones(1, np.float32), np.zeros(1, np.int64))
    layers, shape, in_q = [], (13, 256, 1), q(-128)
    input_q = in_q
    x = rng.integers(-128, 128, (4, *shape)).astype(np.int64)  # the calibration samples
    for i, (kind, (sr, sc), c_out) in enumerate(PACKED_EDGE):
        h, w, c_in = shape
        corners = i == PACKED_EDGE_CORNERS
        out_q = q(0 if corners else int(rng.integers(-128, 100)))
        act = FusedActivation.NONE if corners else ACTS[i % 3]
        xc = x - in_q.zp0
        if kind == "dw":
            g = ViewGeometry(h, w, 3, 3, -(-h // sr), -(-w // sc), sr, sc, ViewPadding.SAME)
            wt = rng.integers(-128, 128, (3, 3, c_out)).astype(np.int8)
            xp = np.pad(xc, ((0, 0), (1, 1), (1, 1), (0, 0)))  # x - in_zp is 0 outside
            acc = sum(xp[:, dh:dh + sr * (g.out_rows - 1) + 1:sr, dw:dw + sc * (g.out_cols - 1)
                         + 1:sc] * wt[dh, dw].astype(np.int64)
                      for dh in range(3) for dw in range(3))
        else:
            g = ViewGeometry(h, w, 1, 1, h, w, 1, 1, ViewPadding.VALID)
            wt = rng.integers(-128, 128, (c_out, 1, 1, c_in)).astype(np.int8)
            if corners:
                halves = [float(v) for v0 in (np.float32(0.5), np.float32(-0.5))
                          for v in (v0, np.nextafter(v0, np.float32(0)),
                                    np.nextafter(v0, 2 * v0))]
                lanes = ([(1, b) for b in halves] + [(0, b) for b in halves]
                         + [(127, 0.0), (-128, 0.0), (0, 1e9), (0, -1e9)])
                wt[:len(lanes)] = np.array([v for v, _ in lanes], np.int8)[:, None, None, None]
            acc = xc @ wt.reshape(c_out, c_in).T.astype(np.int64)
        c1 = (40 / np.maximum(acc.reshape(-1, c_out).std(0), 1)).astype(np.float32)
        c0 = (-acc.reshape(-1, c_out).mean(0) * c1 + rng.normal(0, 5, c_out)).astype(np.float32)
        if corners:
            c0[:len(lanes)], c1[:len(lanes)] = [b for _, b in lanes], 1.0
        lo, hi = activation_bounds(act, out_q.scale0, out_q.zp0)
        x = np.clip(np.round(out_q.zp0 + c0 + c1 * acc), lo, hi).astype(np.int64)
        cls = DepthwiseConv2DLayer if kind == "dw" else Conv2DLayer
        layers.append(cls(i, wt, in_q, w_q, w_q, out_q, c0, c1, g, act, x.shape[1:]))
        shape, in_q = x.shape[1:], out_q
    return Graph(name="packed_edge_graph", layers=layers, input_shape=(13, 256, 1),
                 input_q=input_q, input_dtype=np.dtype(np.int8), output_shape=shape,
                 output_q=in_q, output_dtype=np.dtype(np.int8))


def whole_network_checks(dev, rng) -> dict:
    """``flatpack``, ``colfc``, ``megakernel`` and ``packed`` against their
    plain versions on the card: max |kernel - plain| per kernel and the
    number of checks."""
    errs = {"flatpack": [], "flatpack_fixed": [], "flatpack_raw": [], "flatpack_noround": [],
            "colfc": [], "megakernel": [], "packed": []}
    mma_ops, dw3_ops, mega_paths, packed_paths, packed_corners = {}, {}, {}, {}, {}

    def flat_check(g, label, batches, max_layers=None, requant="exact2"):
        flat_fn, _, meta = build_flat_kernel(g, max_layers=max_layers, requant=requant,
                                             device=dev)
        if requant == "exact2":
            mma_ops[label] = [op.layer_idx for op in flat_fn.ops
                              if op.kind == "pw" and pw_mma(op.in_shape, op.out_shape)]
            dw3_ops[label] = {op.layer_idx: path for op in flat_fn.ops if op.kind == "dw"
                              and (path := dw3_path(op.geom, op.in_shape, op.out_shape))}
        for b in batches:
            xn = rng.integers(-128, 128, (b, meta["in_lanes"]), dtype=np.int8)
            xn.flat[:2] = (-128, 127)  # both int8 rails in every case
            x = torch.from_numpy(xn).to(dev)
            errs[flat_fn.launch_key].append({"case": f"{label} B{b}", "max_abs_err": max_abs_err(
                flat_fn(x), flat_forward_reference(flat_fn.ops, x, requant))})

    def mega_check(g, label, start, batches, x=None):
        """Every segment of the fused (``start`` 0) or hybrid forward; the
        kernel's path of each op is kept in ``mega_paths``."""
        fwd = build_fused_forward(g, start, device=dev)
        mega_paths[label] = [p for seg in fwd.segments for p in seg.paths]
        for seg in fwd.segments:
            idx = seg.segment.indices
            for b in batches:
                xs = x if x is not None else torch.from_numpy(rng.integers(
                    -128, 128, (b, *seg.segment.in_shape), dtype=np.int8)).to(dev)
                errs["megakernel"].append({
                    "case": f"{label} layers {idx[0]}-{idx[-1]} B{xs.shape[0]}",
                    "max_abs_err": max_abs_err(seg(xs), seg.reference(xs))})

    def packed_check(g, label, batches, max_layers=None):
        """The kernel's path of each op is kept in ``packed_paths``; the
        count of outputs that the plan's ``exact2`` form (the mutant of its
        epilogue) would round otherwise, on the largest batch, in
        ``packed_corners``."""
        packed_fn, _, meta = build_packed_kernel(g, max_layers=max_layers, device=dev)
        packed_paths[label] = packed_fn.paths
        for b in batches:
            xn = rng.integers(-128, 128, (b, meta["in_rows"], meta["in_cols"], 1), dtype=np.int8)
            xn.flat[:2] = (-128, 127)[:xn.size]  # both int8 rails in every case
            x = torch.from_numpy(xn).to(dev)
            want = packed_reference(packed_fn.ops, x)
            errs["packed"].append({"case": f"{label} B{b}", "max_abs_err": max_abs_err(
                packed_fn(x), want)})
            if b == max(batches):
                mutant = flat_forward_reference(packed_fn.flat_ops, x.reshape(b, -1), "exact2")
                packed_corners[label] = int((mutant != want.reshape(b, -1)).sum().item())

    def col_check(g, label, x, compute, offset=0):
        """x is copied ``offset`` bytes past an aligned address first."""
        col_fn, meta = build_col_kernel(g, compute=compute, device=dev)
        if offset:
            raw = torch.empty(x.numel() + offset, dtype=torch.int8, device=dev)
            x = raw[offset:].view(x.shape).copy_(x)
        errs["colfc"].append({"case": f"{label} {meta['compute']} B{x.shape[0]} +{offset}",
                              "max_abs_err": max_abs_err(col_fn(x),
                                                         colfc_reference(col_fn.plan, x))})

    pd = parse(model_path("person_detect"))
    for max_layers in (None, 2, 12):
        flat_check(pd, f"person_detect[:{max_layers}]", (64, 3, 0), max_layers)
    for name in ("speech", "sine"):
        flat_check(parse(model_path(name)), name, (64, 3, 0))
    cg = conv_graph(rng)
    for max_layers in (None, 5, 9):
        flat_check(cg, f"conv_graph[:{max_layers}]", (64, 3), max_layers)
    flat_check(pw_edge_graph(rng), "pw_edge_graph", (64, 3, 0))
    flat_check(dw_edge_graph(rng), "dw_edge_graph", (64, 3, 0))
    # the fixed-point epilogue (flat_kernel<R_FIXED>) on every op path
    for max_layers in (None, 2, 12):
        flat_check(pd, f"person_detect[:{max_layers}]", (64, 3, 0), max_layers, "fixed")
    for name in ("speech", "sine"):
        flat_check(parse(model_path(name)), name, (64, 3, 0), requant="fixed")
    flat_check(cg, "conv_graph", (64, 3), requant="fixed")
    flat_check(pw_edge_graph(np.random.default_rng(0)), "pw_edge_graph", (64, 3, 0),
               requant="fixed")
    flat_check(dw_edge_graph(np.random.default_rng(0)), "dw_edge_graph", (64, 3, 0),
               requant="fixed")
    fixed_edges = {}
    sweep = np.concatenate([np.arange(-128, 128), rng.integers(-128, 128, 768)]).astype(np.int8)
    for spec in FIXED_EDGE_ACTS:
        g = fixed_edge_graph(*spec)
        flat_fn, _, _ = build_flat_kernel(g, requant="fixed", device=dev)
        if [op.kind for op in flat_fn.ops] != ["pw", "pw"] or not pw_mma(
                flat_fn.ops[1].in_shape, flat_fn.ops[1].out_shape):
            raise AssertionError(f"{g.name}: its second op is not on the tensor-core path")
        xn = rng.integers(-128, 128, (len(sweep), 4), dtype=np.int8)
        xn[:, 0] = sweep
        x = torch.from_numpy(xn).to(dev)
        errs["flatpack_fixed"].append({"case": g.name, "max_abs_err": max_abs_err(
            flat_fn(x), flat_forward_reference(flat_fn.ops, x, "fixed"))})
        fixed_edges[g.name] = fixed_edge_counts(flat_fn.ops[1], sweep)
        if not all(fixed_edges[g.name].values()):
            raise AssertionError(f"{g.name} misses an edge: {fixed_edges[g.name]}")
    # the measurement-only modes: person_detect and speech at batch 1024, the
    # graphs of the kernel's other paths, and an edge graph each (noround
    # past both rails and outside a RELU6's bounds; raw's accumulators
    # outside int8)
    mode_edges = {}
    for mode in ("raw", "noround"):
        for name in ("person_detect", "speech"):
            flat_check(parse(model_path(name)), name, (1024, 3, 0), requant=mode)
        flat_check(cg, "conv_graph", (64, 3), requant=mode)
        flat_check(pw_edge_graph(np.random.default_rng(0)), "pw_edge_graph", (64, 3),
                   requant=mode)
        flat_check(dw_edge_graph(np.random.default_rng(0)), "dw_edge_graph", (64, 3),
                   requant=mode)
        g = noround_edge_graph() if mode == "noround" else raw_edge_graph()
        flat_fn, _, _ = build_flat_kernel(g, requant=mode, device=dev)
        x = torch.from_numpy(sweep.reshape(-1, 1)).to(dev)
        errs[flat_fn.launch_key].append({"case": g.name, "max_abs_err": max_abs_err(
            flat_fn(x), flat_forward_reference(flat_fn.ops, x, mode))})
        mode_edges[g.name] = mode_edge_counts(g, sweep)
    if not (mode_edges["raw_edge"]["acc_outside_int8"]
            and mode_edges["noround_edge"]["y_past_rails"]
            and mode_edges["noround_edge"]["y_outside_activation_bounds"]):
        raise AssertionError(f"an edge graph of raw/noround misses its edge: {mode_edges}")
    if mma_ops["person_detect[:None]"] != list(range(2, 27, 2)):
        raise AssertionError(f"person_detect's tensor-core 1x1 convs: "
                             f"{mma_ops['person_detect[:None]']}, expected layers 2-26")
    if mma_ops["pw_edge_graph"] != PW_EDGE_MMA:
        raise AssertionError(f"pw_edge_graph's tensor-core 1x1 convs: {mma_ops['pw_edge_graph']}")
    pd_dw = [i for i, layer in enumerate(pd.layers) if isinstance(layer, DepthwiseConv2DLayer)]
    if list(dw3_ops["person_detect[:None]"]) != pd_dw or len(pd_dw) != 14:
        raise AssertionError(f"person_detect's depthwise ops on the 3x3 path: "
                             f"{dw3_ops['person_detect[:None]']}, expected all 14: {pd_dw}")
    if dw3_ops["dw_edge_graph"] != DW_EDGE_DW3:
        raise AssertionError(f"dw_edge_graph's 3x3 depthwise ops: {dw3_ops['dw_edge_graph']}")
    sine = parse(model_path("sine"))
    xs = torch.from_numpy(rng.integers(-128, 128, (1000, 1), dtype=np.int8)).to(dev)
    for compute in ("i32", "f32"):
        col_check(sine, "sine", xs, compute)
    for spec in COL_CHAINS:
        g = col_chain_graph(rng, *spec)
        for b in (0, 1, 15, 17, 1000):
            xn = rng.integers(-128, 128, (b, int(np.prod(g.input_shape))), dtype=np.int8)
            xn.flat[:2] = (-128, 127)[:xn.size]  # both int8 rails
            x = torch.from_numpy(xn).to(dev)
            for compute in ("i32", "f32"):
                col_check(g, g.name, x, compute)
            col_check(g, g.name, x, "i32", offset=1)
    batches = (64, 3, 0)
    for name in MODELS:
        g = parse(model_path(name))
        mega_check(g, f"{name} fused", 0, batches)
    mega_check(pd, "person_detect hybrid", hybrid_split_index(pd), batches)
    # no layer of 64 channels: no hybrid segment
    for g in (cg, conv_graph(rng, wzp=True), pw_edge_graph(np.random.default_rng(0)),
              dw_edge_graph(np.random.default_rng(0)),
              dw_edge_graph(np.random.default_rng(0), wzp=True)):
        mega_check(g, f"{g.name} fused", 0, batches)
    want = {"person_detect fused": {"dw3_stem": 1, "dw3_s1": 9, "dw3_s2": 4, "pw_mma": 13,
                                    "pool": 1, "pw": 1},
            "speech fused": {"dw_vec": 1, "fc": 1}}
    for label, paths in want.items():
        if count_paths(mega_paths[label]) != paths:
            raise AssertionError(f"{label}: the megakernel's paths {mega_paths[label]}")
    if mega_paths["dw_edge_graph_wzp fused"] != DW_EDGE_WZP_PATHS:
        raise AssertionError(f"dw_edge_graph_wzp: the megakernel's paths "
                             f"{mega_paths['dw_edge_graph_wzp fused']}")
    for max_layers in (None, 5, 9, 15):
        packed_check(pd, f"person_detect[:{max_layers}]", batches, max_layers)
    packed_check(packed_graph(rng), "packed_graph", batches)
    packed_check(packed_edge_graph(np.random.default_rng(0)), "packed_edge_graph", batches)
    if count_paths(packed_paths["person_detect[:None]"]) != {"dw3_s1": 8, "dw3_s2": 3,
                                                            "dw3_stem": 1, "pw_mma": 11}:
        raise AssertionError(f"person_detect's packed paths: {packed_paths['person_detect[:None]']}")
    if packed_paths["packed_edge_graph"] != PACKED_EDGE_PATHS:
        raise AssertionError(f"packed_edge_graph's paths: {packed_paths['packed_edge_graph']}")
    if not packed_corners["packed_edge_graph"]:
        raise AssertionError("no output of packed_edge_graph on the exact2 corner")
    graphs, n_fma = edge_graphs(rng)
    sweep = np.concatenate([np.arange(-128, 128), rng.integers(-128, 128, 768)]).astype(np.int8)
    x = torch.from_numpy(sweep.reshape(-1, 1)).to(dev)
    corners = {}
    for g in graphs:
        flat_fn, _, _ = build_flat_kernel(g, device=dev)
        errs["flatpack"].append({"case": g.name, "max_abs_err": max_abs_err(
            flat_fn(x), flat_forward_reference(flat_fn.ops, x))})
        for compute in ("i32", "f32"):
            col_check(g, g.name, x, compute)
        mega_check(g, g.name, 0, (len(sweep),), x)
        corners[g.name] = exact2_corners(g, sweep)
    if not corners["edge_c1_one"]:
        raise AssertionError("no lane of edge_c1_one on the exact2 corner")
    return {"checks": errs, "fma_sensitive_lanes": n_fma, "exact2_corner_lanes": corners,
            "fixed_edge_counts": fixed_edges, "mode_edge_counts": mode_edges,
            "mma_ops": {k: len(v) for k, v in mma_ops.items()},
            "dw3_ops": {k: len(v) for k, v in dw3_ops.items()},
            "mega_paths": {k: count_paths(v) for k, v in mega_paths.items()},
            "packed_paths": {k: count_paths(v) for k, v in packed_paths.items()},
            "packed_edge_paths": packed_paths["packed_edge_graph"],
            "packed_exact2_corner_outputs": packed_corners}


def count_paths(paths: list) -> dict:
    """How many ops take each path, by path name."""
    return {p: paths.count(p) for p in sorted(set(paths))}


# --- timing -------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms a call: ``iters`` calls captured in one CUDA graph, replayed
    between two CUDA events, so the host's cost a call is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = time_ms(graph.replay, 1, warmup=0) / iters
    del graph
    return ms


def bound(name, args, kw, out) -> tuple[float, str, int, int]:
    """Least time for the call: (bytes moved at HBM rate) vs (operations at
    the int8 peak), the larger; each input read once, the output written
    once."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel()
    if name == "qgemm":
        (m, k), n = args[0].shape, args[1].shape[1]
        ops = 2 * m * k * n
    else:
        ops = 2 * out.numel() * kw["kh"] * kw["kw"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def int_mm_call(args):
    """``torch._int_mm`` on the same product; K and N are zero-padded to
    what it accepts (multiples of 8, K >= 16) outside the timed call."""
    x, w = args[0], args[1]
    (m, k), n = x.shape, w.shape[1]
    kp, np_ = max(16, -(-k // 8) * 8), -(-n // 8) * 8
    if (kp, np_) != (k, n):
        x = torch.nn.functional.pad(x, (0, kp - k))
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    return lambda: torch._int_mm(x, w)


def dw_padded(args, kw) -> torch.Tensor:
    """A ``qdwconv`` call's input as the JAX kernel takes it: padded with
    ``in_zp``, the stem's one channel repeated to all C."""
    geo = {k: kw[k] for k in ("in_zp", "pad_top", "pad_left", "kh", "kw", "sr", "sc", "oh", "ow")}
    return zp_padded(args[0], args[1].shape[2], **geo).contiguous()


def dw_conv_call(args, kw):
    """cuDNN's depthwise convolution (``conv2d`` with ``groups=C``, f32,
    TF32 off) on the padded input (the stem's channel repeated to all C)
    and the centred weights, made f32 and NCHW (channels-last in memory)
    outside the timed call.  Returns the call and its output as int32 NHWC:
    the accumulators without ``d``, exact since every partial sum is an
    integer below 9 * 128 * 255 < 2**24."""
    xp, wc = dw_padded(args, kw), args[1]
    c = xp.shape[3]
    x = xp.permute(0, 3, 1, 2).to(torch.float32)
    w = wc.permute(2, 0, 1).unsqueeze(1).to(torch.float32).contiguous()  # [C, 1, KH, KW]
    fn = lambda: torch.nn.functional.conv2d(x, w, stride=(kw["sr"], kw["sc"]), groups=c)
    acc = fn()[:, :, :kw["oh"], :kw["ow"]].permute(0, 2, 3, 1).to(torch.int32)
    return fn, acc


def dw_accumulators(args, kw) -> torch.Tensor:
    """The plain version's int32 accumulators of a ``qdwconv`` call, without
    ``d``."""
    xp, wc = dw_padded(args, kw), args[1]
    geom = ViewGeometry(xp.shape[1], xp.shape[2], kw["kh"], kw["kw"], kw["oh"], kw["ow"],
                        kw["sr"], kw["sc"], ViewPadding.VALID)
    return window_sum(xp, wc.to(torch.int32), geom)


def time_kernels(calls) -> dict:
    """Per-call times at the captured shapes; sums per kernel.  The library
    yardsticks: ``torch._int_mm`` for ``qgemm``, and for ``qdwconv`` cuDNN's
    depthwise ``conv2d``, first checked equal to the integer accumulators."""
    res = {}
    for name, lst in calls.items():
        if not lst:
            continue
        rows = []
        for args, kw in lst:
            kern = getattr(kernels, name)
            ref = getattr(kernels, f"{name}_reference")
            out = kern(*args, **kw)
            err = max_abs_err(out, ref(*args, **kw))
            t_bound, by, nbytes, ops = bound(name, args, kw, out)
            row = {"shape": _shape(name, args, kw), "max_abs_err": err,
                   "ms": time_ms(lambda: kern(*args, **kw), 20),
                   "plain_ms": time_ms(lambda: ref(*args, **kw), 3, warmup=1),
                   "bound_ms": t_bound, "bound_by": by, "bytes": nbytes, "ops": ops,
                   "library_ms": None}
            if name == "qgemm":
                row["library_ms"] = time_ms(int_mm_call(args), 20)
                # device times (a small call's ms is the host's); the other
                # path on the same call: what the rule's threshold rests on
                row["device_ms"] = graph_ms(lambda: kern(*args, **kw))
                row["library_device_ms"] = graph_ms(int_mm_call(args))
                other = QGEMM_PATHS[1 - QGEMM_PATHS.index(row["shape"]["path"])]
                okw = {**kw, "path": other}
                row["other_path"] = {
                    "path": other, "max_abs_err": max_abs_err(kern(*args, **okw), out),
                    "ms": time_ms(lambda: kern(*args, **okw), 20),
                    "device_ms": graph_ms(lambda: kern(*args, **okw))}
            else:
                lib, acc = dw_conv_call(args, kw)
                row["library_max_abs_err"] = int(
                    (acc - dw_accumulators(args, kw)).abs().max().item()) if acc.numel() else 0
                del acc
                row["library_ms"] = time_ms(lib, 20)
            rows.append(row)
        tot = lambda key: sum(r[key] for r in rows)
        res[name] = {
            "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if sum(r["bound_by"] == "bytes" for r in rows) * 2 >= len(rows)
            else "operations",
            "library_ms": tot("library_ms"),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "launches_per_forward": len(rows), "per_call": rows,
        }
        if name == "qgemm":
            res[name]["by_path"] = {p: {
                "launches": sum(r["shape"]["path"] == p for r in rows),
                **{k: sum(r[k] for r in rows if r["shape"]["path"] == p)
                   for k in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
                **{f"other_path_{k}": sum(r["other_path"][k] for r in rows
                                          if r["shape"]["path"] == p)
                   for k in ("ms", "device_ms")}} for p in QGEMM_PATHS}
            if any(r["other_path"]["max_abs_err"] for r in rows):
                raise AssertionError("qgemm's two paths differ at a timed shape")
        if name == "qdwconv":
            res[name]["library_max_abs_err"] = max(r["library_max_abs_err"] for r in rows)
            if res[name]["library_max_abs_err"]:
                raise AssertionError("cuDNN's depthwise conv2d differs from the integer "
                                     f"accumulators: {res[name]['library_max_abs_err']}")
    return res


def time_whole_network(dev, rng) -> dict:
    """``flatpack`` on person_detect and speech at batch 8192, ``colfc`` on
    sine at batch 1,048,576, and ``megakernel`` (the fused segment, layers
    0-28) and ``packed`` (the prefix, layers 0-22) on person_detect at batch
    8192, beside their plain versions and bounds."""
    res = {}
    for name in ("person_detect", "speech"):
        flat_fn, _, meta = build_flat_kernel(parse(model_path(name)), device=dev)
        x = torch.from_numpy(rng.integers(-128, 128, (8192, meta["in_lanes"]),
                                          dtype=np.int8)).to(dev)
        res[f"flatpack_{name}"] = timed(flat_fn, lambda v: flat_forward_reference(flat_fn.ops, v),
                                        x, *flat_bound(flat_fn.ops, 8192))
        if name == "person_detect":  # the fixed epilogue on the same input, in the same call
            fixed_fn, _, _ = build_flat_kernel(parse(model_path(name)), requant="fixed",
                                               device=dev)
            res["flatpack_fixed_person_detect"] = timed(
                fixed_fn, lambda v: flat_forward_reference(fixed_fn.ops, v, "fixed"), x,
                *flat_bound(fixed_fn.ops, 8192))
            res["flatpack_person_detect"]["ms_after_fixed"] = time_ms(lambda: flat_fn(x), 20)
            # the measurement-only modes on the same input, then exact2 again:
            # exact2 - noround prices the round and the clip, noround - raw
            # the affine f32 epilogue (ROADMAP B speed item 1)
            for mode in ("raw", "noround"):
                fn, _, _ = build_flat_kernel(parse(model_path(name)), requant=mode, device=dev)
                res[f"flatpack_{mode}_person_detect"] = timed(
                    fn, lambda v, fn=fn, mode=mode: flat_forward_reference(fn.ops, v, mode), x,
                    *flat_bound(fn.ops, 8192))
            res["flatpack_person_detect"]["ms_after_modes"] = time_ms(lambda: flat_fn(x), 20)
        del x
        torch.cuda.empty_cache()
    col_fn, meta = build_col_kernel(parse(model_path("sine")), device=dev)
    b = 1 << 20
    x = torch.from_numpy(rng.integers(-128, 128, (b, 1), dtype=np.int8)).to(dev)
    weights = sum(int(wt.size) for wt, *_ in col_fn.plan)
    res["colfc_sine"] = timed(col_fn, lambda v: colfc_reference(col_fn.plan, v), x,
                              b * (meta["k0"] + meta["n_out"]) + weights, 2 * b * weights,
                              compute=meta["compute"])
    res["colfc_sine"]["device_ms"] = graph_ms(lambda: col_fn(x))
    pd = parse(model_path("person_detect"))
    x = torch.from_numpy(rng.integers(-128, 128, (8192, 96, 96, 1), dtype=np.int8)).to(dev)
    (seg,) = build_fused_forward(pd, 0, device=dev).segments
    weights = sum(int(w.size) for w in map(layer_weights, seg.segment.layers) if w is not None)
    nbytes = 8192 * (seg.segment.in_elems + seg.segment.out_elems) + weights
    res["megakernel_person_detect"] = timed(
        seg, seg.reference, x, nbytes, 2 * 8192 * seg.segment.macs(),
        layers=f"{seg.segment.indices[0]}-{seg.segment.indices[-1]}")
    packed_fn, n_layers, _ = build_packed_kernel(pd, device=dev)
    nbytes, ops = packed_bound(packed_fn.ops, 8192)
    res["packed_person_detect"] = timed(
        packed_fn, lambda v: packed_reference(packed_fn.ops, v), x, nbytes, ops,
        layers=f"0-{n_layers - 1}", paths=count_paths(packed_fn.paths))
    # the yardstick: the flat kernel in exact mode on the same layers, whose
    # plan is the packed kernel's, on the same input; then packed again
    flat_fn, _, _ = build_flat_kernel(pd, max_layers=n_layers, requant="exact", device=dev)
    x2 = x.reshape(8192, -1)
    res["flatpack_exact_packed_layers"] = timed(
        flat_fn, lambda v: flat_forward_reference(flat_fn.ops, v, "exact"), x2, nbytes, ops,
        layers=f"0-{n_layers - 1}",
        equal_to_packed=bool(torch.equal(flat_fn(x2), packed_fn(x).reshape(8192, -1))))
    res["packed_person_detect"]["ms_after_flat"] = time_ms(lambda: packed_fn(x), 20)
    return res


# sine's timed batches: the last two are the kernel's, the first one's
# call ms less its device ms is the wrappers' host cost a call
SINE_BATCHES = (1024, 1 << 20, 1 << 24)


def time_sine(dev, rng) -> dict:
    """sine at ``SINE_BATCHES`` through ``colfc``, the ``pallas`` path and
    the flat kernel, each output checked equal to ``colfc_reference``: call
    ms (CUDA events around 20 calls; ``pallas``: 20 forwards through
    ``predict_inner``) and device ms (``graph_ms``; ``pallas``: the sum over
    its three ``qgemm`` launches, each replayed alone) beside the bound of
    the function (each input and output byte and the weights once, or
    2 x MACs at the int8 peak)."""
    sine = parse(model_path("sine"))
    col_fn, meta = build_col_kernel(sine, device=dev)
    flat_fn, _, _ = build_flat_kernel(sine, device=dev)
    pallas = compile_tflite(model_path("sine"), name="sine", backend="pallas")
    weights = sum(int(wt.size) for wt, *_ in col_fn.plan)
    res = {}
    for b in SINE_BATCHES:
        x = torch.from_numpy(rng.integers(-128, 128, (b, meta["k0"]), dtype=np.int8)).to(dev)
        want = colfc_reference(col_fn.plan, x)
        nbytes, ops = b * (meta["k0"] + meta["n_out"]) + weights, 2 * b * weights
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        row = {"bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        for name, fn in (("colfc", col_fn), ("flat", flat_fn)):
            row[name] = {"max_abs_err": max_abs_err(fn(x), want), "ms": time_ms(lambda: fn(x), 20),
                         "device_ms": graph_ms(lambda: fn(x)), "launches": 1}
        with Recorder("capture") as rec:
            y = pallas.predict_inner(x)
        calls = rec.calls["qgemm"]
        row["pallas"] = {"max_abs_err": max_abs_err(y.reshape(want.shape), want),
                         "ms": time_ms(lambda: pallas.predict_inner(x), 20),
                         "device_ms": sum(graph_ms(lambda a=a, k=k: kernels.qgemm(*a, **k))
                                          for a, k in calls),
                         "launches": len(calls)}
        del rec, calls, y, want, x
        torch.cuda.empty_cache()
        res[str(b)] = row
    return res


def layer_weights(layer):
    """The int8 weight array of a layer, or None."""
    return getattr(layer, "filters", getattr(layer, "weights", None))


def timed(kern, ref, x, nbytes: int, ops: int, **extra) -> dict:
    """A kernel and its plain version on ``x``, beside the bound."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return {"batch": x.shape[0], **extra, "max_abs_err": max_abs_err(kern(x), ref(x)),
            "ms": time_ms(lambda: kern(x), 20),
            "plain_ms": time_ms(lambda: ref(x), 3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "library_ms": None}


# --- the 1x1 convs' folded weight gradients (qwgrad) -------------------------

INT_MIN = -2**31


def pointwise_layer(layer, F: int | None = None, C: int | None = None, rows: int | None = None,
                    cols: int | None = None, in_zp: int | None = None):
    """A copy of the 1x1 conv ``layer`` with other filter or channel counts,
    another plane or another input zero point."""
    f0, _, _, c0 = layer.filters.shape
    geom = layer.geom
    if rows is not None:
        geom = dataclasses.replace(geom, in_rows=rows, in_cols=cols, out_rows=rows,
                                   out_cols=cols)
    in_q = layer.in_q
    if in_zp is not None:
        in_q = dataclasses.replace(in_q, zero_point=np.array([in_zp], np.int64))
    return dataclasses.replace(layer, filters=np.zeros((F or f0, 1, 1, C or c0), np.int8),
                               geom=geom, in_q=in_q)


def qwgrad_inputs(layer, batch: int, gen: torch.Generator, acc_bound: int = 2**20):
    """Seeded (x_q, md, acc) for ``layer``: int8 inputs, a masked dOut with
    about half of its entries and a tenth of its columns zero (as ReLU6
    masks leave it), and an accumulator within ``acc_bound``."""
    F_, _, _, C = layer.filters.shape
    g = layer.geom
    x = torch.randint(-128, 128, (batch, g.in_rows, g.in_cols, C), generator=gen,
                      dtype=torch.int8)
    md = torch.randint(-2**20, 2**20, (batch, g.out_rows, g.out_cols, F_), generator=gen,
                       dtype=torch.int32)
    md *= torch.rand(md.shape, generator=gen) < 0.5
    md *= torch.rand((batch, 1, 1, F_), generator=gen) >= 0.1
    acc = torch.randint(-acc_bound, acc_bound + 1, (F_, 1, 1, C), generator=gen,
                        dtype=torch.int32)
    return x, md, acc


def qwgrad_edge_inputs(layer, batch: int, gen: torch.Generator):
    """``qwgrad_inputs`` with planted columns of the masked dOut, a sample
    each: all zero; two INT_MINs (the wrapped norm 0: quotients of +-inf and
    0/0); a single 1 and a single -1 (quotients past +-127); 1, 1 (norm 2:
    exact .5 ties of both signs); 3, -1 (norm 4); full-range int32 entries
    (wrapped products and norms); INT_MAX beside INT_MIN.  Needs 2
    positions a sample and 7 samples."""
    x, md, acc = qwgrad_inputs(layer, batch, gen, acc_bound=2**31 - 1)
    B, H, W, F_ = md.shape
    flat = md.view(B, H * W, F_)
    planted = ([0], [INT_MIN, INT_MIN], [1], [-1], [1, 1], [3, -1])
    for b, column in enumerate(planted):
        f = b % F_
        flat[b, :, f] = 0
        flat[b, :len(column), f] = torch.tensor(column, dtype=torch.int32)
    flat[len(planted)] = torch.randint(INT_MIN, 2**31, (H * W, F_), generator=gen,
                                       dtype=torch.int64).to(torch.int32)
    flat[len(planted), :2, 0] = torch.tensor([2**31 - 1, INT_MIN], dtype=torch.int32)
    return x, md, acc


def qwgrad_cases(graph, batch: int, gen: torch.Generator) -> list:
    """(name, layer, x_q, md, acc) for qwgrad: person_detect's four 1x1
    convs at ``batch``; then at odd sizes (13 samples, which no chunk of the
    kernel divides) the planted edges on layer 24, the same at in_zp 127 and
    0, widths no tile or load divides (F 70, C 67; F 2, C 5), and 56
    positions a sample (two stages of the kernel's 48)."""
    layers = {i: graph.layers[i] for i in PD_POINTWISE}
    cases = [(f"layer{i}", layer, *qwgrad_inputs(layer, batch, gen))
             for i, layer in layers.items()]
    base = layers[24]
    for name, layer in (("edges", base), ("edges_zp127", pointwise_layer(base, in_zp=127)),
                        ("edges_zp0", pointwise_layer(base, in_zp=0)),
                        ("edges_f70_c67", pointwise_layer(base, F=70, C=67)),
                        ("edges_f2_c5", pointwise_layer(base, F=2, C=5)),
                        ("edges_p56", pointwise_layer(base, rows=7, cols=8))):
        cases.append((name, layer, *qwgrad_edge_inputs(layer, 13, gen)))
    return cases


def qwgrad_macs(layer, batch: int) -> int:
    F_, _, _, C = layer.filters.shape
    return batch * F_ * C * layer.geom.out_rows * layer.geom.out_cols


def qwgrad_checks(dev, graph, batch: int = 1024) -> dict:
    """``qwgrad`` on the card against its plain version at ``qwgrad_cases``
    (entries that differ, each case); at person_detect's four shapes, ms
    beside the plain version's and beside the bound: the larger of the
    bytes read and written at HBM rate and the int32 multiply-adds at
    ``INT32_MACS_PER_S`` (the divides, one an entry and sample, add ~8
    instructions each on top).  No PyTorch call computes the fold."""
    from microflow_tpu_torch.kernels.qwgrad import qwgrad, qwgrad_reference

    gen = torch.Generator().manual_seed(26)
    rows, wrong = [], {}
    for name, layer, x, md, acc in qwgrad_cases(graph, batch, gen):
        x, md, acc = x.to(dev), md.to(dev), acc.to(dev)
        got, want = qwgrad(layer, x, md, acc), qwgrad_reference(layer, x, md, acc)
        wrong[name] = int((got != want).sum())
        if name.startswith("layer"):
            nbytes = md.numel() * 4 + x.numel() + 2 * acc.numel() * 4
            rows.append({"layer": name, "shape": {"B": x.shape[0], "P": md.shape[1] * md.shape[2],
                                                  "F": md.shape[-1], "C": x.shape[-1]},
                         "ms": time_ms(lambda: qwgrad(layer, x, md, acc), 20),
                         "plain_ms": time_ms(lambda: qwgrad_reference(layer, x, md, acc), 3,
                                             warmup=1),
                         "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                         qwgrad_macs(layer, x.shape[0]) / INT32_MACS_PER_S) * 1e3})
        del x, md, acc, got, want
    torch.cuda.empty_cache()
    if any(wrong.values()):
        raise AssertionError(f"qwgrad differs from its plain version: {wrong}")
    return {"entries_wrong": wrong, "max_abs_err": 0, "batch": batch, "per_layer": rows,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "instructions",
            "library_ms": None}


def wgrad_step_check(dev, batch: int = 64, steps: int = 3) -> dict:
    """person_detect_trainable(10) on the card (its 1x1 convs' weight
    gradients through ``qwgrad``, the first step eager, the others
    replayed) against the same on the CPU (plain torch) from the same
    params: outputs, grads and params bit-equal after every step."""
    mc = person_detect_trainable(10, backend="pallas", device=dev)
    mh = person_detect_trainable(10, device="cpu")
    mh.params = {k: {kk: v.cpu() for kk, v in d.items()} for k, d in mc.params.items()}
    gen = torch.Generator().manual_seed(27)
    before = {n: COUNTERS[n] for n in (WGRAD_FOLDS, WGRAD_PLAIN)}
    for step in range(steps):
        xq, gt = train_batch(mh, batch, gen)
        out = mc.predict_quantized_train(xq.to(dev), gt.to(dev), TRAIN_LR)
        want = mh.predict_quantized_train(xq, gt, TRAIN_LR)
        if not torch.equal(out.cpu(), want):
            raise AssertionError(f"card vs CPU trainer: output of step {step} differs")
        _same_state({k: {kk: v.cpu() for kk, v in d.items()} for k, d in mc.grads.items()},
                    mh.grads, f"card vs CPU trainer, grads after step {step}")
        mc.update_layers(batch, TRAIN_LR)
        mh.update_layers(batch, TRAIN_LR)
        _same_state({k: {kk: v.cpu() for kk, v in d.items()} for k, d in mc.params.items()},
                    mh.params, f"card vs CPU trainer, params after update {step}")
    counted = {n: COUNTERS[n] - before[n] for n in before}
    want = {WGRAD_FOLDS: 4 * steps, WGRAD_PLAIN: 4 * steps}  # the card's, then the CPU's
    if counted != want:
        raise AssertionError(f"wgrad counters {counted}, expected {want}")
    return {"batch": batch, "steps": steps, "counters": counted}


# --- training -----------------------------------------------------------------

# (model, gradient_mode): the three bundled models' reference training
# configurations, and sine's f32-gradient twin
TRAIN_CASES = (("person_detect", "quantized"), ("speech", "quantized"), ("sine", "quantized"),
               ("sine", "float"))
TRAIN_LR = 0.05


def trainer(name: str, backend: str, mode: str, dev) -> TrainableModel:
    if name == "person_detect":
        return person_detect_trainable(10, backend=backend, device=dev)
    make = sine_trainable if name == "sine" else speech_trainable
    return make(backend=backend, gradient_mode=mode, device=dev)


def train_batch(model: TrainableModel, batch: int, gen: torch.Generator):
    """Seeded int8 inputs and targets: one-hot labels on the softmax's grid
    (127 / -128) for crossentropy, int8 values for mse."""
    g = model.graph
    xq = torch.randint(-128, 128, (batch, *g.input_shape), generator=gen, dtype=torch.int8)
    if model.loss == "crossentropy":
        gt = torch.full((batch, *g.output_shape), -128, dtype=torch.int8)
        gt[torch.arange(batch), torch.randint(0, g.output_shape[-1], (batch,), generator=gen)] = 127
    else:
        gt = torch.randint(-128, 128, (batch, *g.output_shape), generator=gen, dtype=torch.int8)
    return xq.to(model.device), gt.to(model.device)


def _same_state(a: dict, b: dict, what: str) -> None:
    for layer, arrays in a.items():
        for k, v in arrays.items():
            if not torch.equal(v, b[layer][k]):
                raise AssertionError(f"{what}: {layer}/{k} differs "
                                     f"({int((v != b[layer][k]).sum())} entries)")


def train_checks(dev, batch: int = 256, steps: int = 3) -> dict:
    """For each of ``TRAIN_CASES``: a trainer on ``"pallas"`` and one on
    ``"xla"`` from the same params, ``steps`` steps of
    ``predict_quantized_train`` then ``update_layers`` on seeded batches;
    grads after every step and params after every update must be
    bit-equal.  Returns, a case, each trained layer's count of nonzero
    weight-gradient entries after each step (every layer must have some in
    one step at least), the kernel launches of each backend's steps, and
    how many of each backend's steps replayed as CUDA graphs and how many
    ran eager (on the card the first eager, the others replayed)."""
    out = {}
    for name, mode in TRAIN_CASES:
        mp, mx = (trainer(name, b, mode, dev) for b in ("pallas", "xla"))
        mx.params = {k: {kk: v.clone() for kk, v in d.items()} for k, d in mp.params.items()}
        gen = torch.Generator().manual_seed(15)
        nonzero, launches = [], {}
        kinds = {b: Counter() for b in ("pallas", "xla")}
        for step in range(steps):
            xq, gt = train_batch(mp, batch, gen)
            for backend, m in (("pallas", mp), ("xla", mx)):
                LAUNCHES.clear()
                m.predict_quantized_train(xq, gt, TRAIN_LR)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                launches.setdefault(backend, []).append(dict(LAUNCHES))
            _same_state(mp.grads, mx.grads, f"{name}/{mode} pallas vs xla, grads after step {step}")
            nonzero.append({k: int(v["weights_gradient"].count_nonzero())
                            for k, v in mp.grads.items()})
            for backend, m in (("pallas", mp), ("xla", mx)):
                before = dict(COUNTERS)
                m.update_layers(batch, TRAIN_LR)  # the step ends, and is counted
                for kind, counter in (("graph", GRAPH_STEPS), ("eager", EAGER_STEPS)):
                    kinds[backend][kind] += COUNTERS[counter] - before[counter]
            _same_state(mp.params, mx.params,
                        f"{name}/{mode} pallas vs xla, params after update {step}")
        dead = [k for k in nonzero[0] if not any(n[k] for n in nonzero)]
        if dead:
            raise AssertionError(f"{name}/{mode}: no gradient reached {dead} in {steps} steps")
        out[f"{name}/{mode}"] = {"nonzero_weight_gradients": nonzero, "launches": launches,
                                 "steps": {b: dict(k) for b, k in kinds.items()}}
    return out


def time_training(dev, smi: str, batch: int = 1024) -> dict:
    """ms a train step (forward, backward and fold) and an
    ``update_layers`` of person_detect at ``batch`` through ``"pallas"`` and
    ``"xla"`` in turns (pallas, xla, xla, pallas), CUDA events around 5 of
    each after 2 warm-up steps."""
    models = {b: trainer("person_detect", b, "quantized", dev) for b in ("pallas", "xla")}
    xq, gt = train_batch(models["pallas"], batch, torch.Generator().manual_seed(16))
    runs = {b: {"step_ms": [], "update_ms": []} for b in models}
    for backend in ("pallas", "xla", "xla", "pallas"):
        m = models[backend]
        runs[backend]["step_ms"].append(
            time_ms(lambda: m.predict_quantized_train(xq, gt, TRAIN_LR), 5, warmup=2))
        runs[backend]["update_ms"].append(
            time_ms(lambda: m.update_layers(batch, TRAIN_LR), 5, warmup=2))
    return {"model": "person_detect_trainable(10)", "batch": batch, "device": smi, **runs}


ROOT = os.path.dirname(os.path.abspath(__file__))
# the real samples' pinned outputs (tests/test_samples.py): feature -> (model,
# label, {output index: value})
SAMPLE_GOLDENS = {
    "person_detect_person": ("person_detect", "person", {0: 0.26953125, 1: 0.73046875}),
    "person_detect_no_person": ("person_detect", "no person", {0: 0.6171875, 1: 0.3828125}),
    "speech_yes": ("speech", "yes", {2: 0.99609375}),
    "speech_no": ("speech", "no", {3: 0.9453125}),
}


def run_entry(*argv) -> subprocess.CompletedProcess:
    """``python <argv>`` from the checkout's root; a non-zero exit raises."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"{' '.join(argv)} exited {out.returncode}: {out.stderr[-3000:]}")
    return out


def entry_points(dev, rng) -> dict:
    """bench_torch.py and three CLI commands as subprocesses; the real
    samples through ``flat``; the bundled models exported and reparsed; the
    CLI's ``train`` (in process) on person_detect, its export and its
    checkpoint."""
    import io
    import tempfile

    from microflow_tpu_torch import samples
    from microflow_tpu_torch.__main__ import main as cli
    from microflow_tpu_torch.utils import load_params

    t = time.time()
    res = {}
    out = run_entry("bench_torch.py", "--batch", "8192")
    bench = json.loads(out.stdout.strip().splitlines()[-1])
    if bench.get("metric") != "person_detect_inferences_per_sec_per_chip" or not bench["value"] > 0:
        raise AssertionError(f"bench_torch.py printed {bench}")
    if "golden output bit-exact" not in out.stderr:
        raise AssertionError(f"bench_torch.py checked no golden: {out.stderr}")
    ms = re.search(r"batch=\d+: ([0-9.]+) ms/batch", out.stderr)
    res["bench_torch"] = {"line": bench, "ms_per_batch": float(ms.group(1)),
                          "stderr": out.stderr.strip().splitlines()}
    out = run_entry("-m", "microflow_tpu_torch", "inspect", "models/person_detect.tflite")
    if "layers: 31" not in out.stdout:
        raise AssertionError(f"inspect printed {out.stdout}")
    out = run_entry("-m", "microflow_tpu_torch", "predict", "models/sine.tflite", "--fill", "0.5")
    if "0.41348344" not in out.stdout:
        raise AssertionError(f"predict printed {out.stdout}, not the sine golden 0.41348344")
    res["cli_predict_sine"] = out.stdout.strip()
    out = run_entry("-m", "microflow_tpu_torch", "expansion", "models/person_detect.tflite")
    if "flat_kernel<R_EXACT2> (csrc/flatpack.cu" not in out.stdout:
        raise AssertionError(f"expansion names no flat_kernel: {out.stdout[-3000:]}")
    res["cli_expansion_kernel_lines"] = [ln for ln in out.stdout.splitlines() if "csrc/" in ln]

    feats = samples.load_features()
    models = {name: compile_tflite(model_path(name), name=name) for name in ("person_detect",
                                                                             "speech")}
    LAUNCHES.clear()
    res["samples"] = {}
    for key, (name, label, want) in SAMPLE_GOLDENS.items():
        got = models[name].predict_quantized(feats[key])[0].cpu().numpy()
        labels = samples.PERSON_DETECT_LABELS if name == "person_detect" else samples.SPEECH_LABELS
        if labels[int(np.argmax(got))] != label or any(
                got[i] != np.float32(v) for i, v in want.items()):
            raise AssertionError(f"{key}: {got} is not labelled {label!r} with {want}")
        res["samples"][key] = {"backend": models[name].backend, "output": got.tolist(),
                               "label": label}
    res["samples_launches"] = dict(LAUNCHES)
    if res["samples_launches"] != {"flatpack": 4}:
        raise AssertionError(f"the samples launched {res['samples_launches']}, expected 4 "
                             "flatpack launches and no other")

    with tempfile.TemporaryDirectory() as d:
        res["export_round_trip"] = {}
        for name in MODELS:
            m = compile_tflite(model_path(name), name=name)
            path = os.path.join(d, f"{name}.tflite")
            m.export(path)
            m2 = compile_tflite(path, name=name)
            xq = random_input(m, 1024, rng)
            err = max_abs_err(m2.predict_inner(xq), m.predict_inner(xq))
            res["export_round_trip"][name] = {"backend": m2.backend, "batch": 1024,
                                              "max_abs_err": err}
            if err or m2.backend != m.backend:
                raise AssertionError(f"{name} exported and reparsed: {res['export_round_trip']}")

        ck, tfl = os.path.join(d, "pd10.npz"), os.path.join(d, "pd10.tflite")
        log = io.StringIO()
        LAUNCHES.clear()
        with contextlib.redirect_stdout(log):
            trained, x = cli(["train", "models/person_detect.tflite", "--layers", "10", "--loss",
                              "crossentropy", "--skip-last", "--epochs", "1", "--batch", "256",
                              "--save", ck, "--export", tfl])
        torch.cuda.synchronize()
        train_launches = dict(LAUNCHES)
        if trained.backend != "pallas" or set(train_launches) != {"qgemm", "qdwconv", "qsoftmax",
                                                                  "qwgrad"}:
            raise AssertionError(f"CLI train ran {trained.backend}, launched {train_launches}")
        xq = trained.quantize_input(x)
        want = trained.predict_inner(xq)
        exported = compile_tflite(tfl, name="person_detect")
        got = exported.predict_inner(xq)
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        # export quantizes each trained C0 to its integer bias: the trained
        # weights with the exported C0s, per op, give the export's bits
        grid = parse(tfl)
        on_grid = compile_tflite(model_path("person_detect"), name="person_detect",
                                 backend="pallas")
        on_grid.params = {k: {**v, "c0": torch.as_tensor(grid.layers[int(k[5:])].c0, device=dev)}
                          for k, v in trained.params.items()}
        grid_err = max_abs_err(got, on_grid.predict_inner(xq))
        fresh = person_detect_trainable(10, backend="pallas")
        fresh.params = load_params(ck)
        reload_err = max_abs_err(fresh.predict_inner(xq), want)
        res["cli_train"] = {
            "argv": "train models/person_detect.tflite --layers 10 --loss crossentropy "
                    "--skip-last --epochs 1 --batch 256 --save --export",
            "stdout": log.getvalue().strip().splitlines(), "backend": trained.backend,
            "launches": train_launches, "exported_backend": exported.backend,
            "exported_vs_trained_max_lsb": int(diff.max().item()),
            "exported_vs_trained_outputs_differing": int((diff > 0).sum().item()),
            "outputs": int(diff.numel()),
            "exported_vs_trained_with_exported_c0_max_abs_err": grid_err,
            "checkpoint_reload_max_abs_err": reload_err}
        if exported.backend != "flat" or grid_err or reload_err:
            raise AssertionError(f"CLI train's export or checkpoint: {res['cli_train']}")
    res["seconds"] = round(time.time() - t, 1)
    return res


# --- serving (phase 9) ---------------------------------------------------------


def same_graph(a, b, path: str = "graph") -> None:
    """Raise unless two parsed graphs agree in every field, bit for bit."""
    if dataclasses.is_dataclass(a):
        if type(a) is not type(b):
            raise AssertionError(f"{path}: {type(a).__name__} != {type(b).__name__}")
        for f in dataclasses.fields(a):
            same_graph(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"{path}: arrays differ")
    elif isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise AssertionError(f"{path}: {a!r} != {b!r}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_graph(x, y, f"{path}[{i}]")
    elif isinstance(a, np.generic):
        if type(a) is not type(b) or a.tobytes() != b.tobytes():
            raise AssertionError(f"{path}: {a!r} != {b!r}")
    elif type(a) is not type(b) or a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def front_end_checks() -> dict:
    """The native parser against the Python one on the three models, and
    which reader ``compile_tflite`` used."""
    from microflow_tpu_torch import native
    from microflow_tpu_torch.frontend import native_backend

    if not native.available():
        raise AssertionError(f"the native front end does not build: {native._build_error}")
    for name in MODELS:
        same_graph(parse(model_path(name), frontend="native"),
                   parse(model_path(name), frontend="python"), name)
    loaded = []
    orig = native_backend.load_model

    def load(path):
        model = orig(path)
        loaded.append(path)
        return model

    native_backend.load_model = load
    try:
        compile_tflite(model_path("person_detect"), name="person_detect")
    finally:
        native_backend.load_model = orig
    return {"native_available": True, "native_equals_python": list(MODELS),
            "compile_tflite_frontend": "native" if loaded else "python",
            "library": native.build()}


SERVE_CLIENTS = 16
SERVE_PER_CLIENT = 8
SERVE_MAX_BATCH = 1024
SERVE_BIG = 1500  # one request over max_batch


SERVE_KINDS = ("f32", "int8_host", "int8_device")


def serve_requests(model, rng, dev, clients: int, per_client: int, big: int | None,
                   kinds=SERVE_KINDS) -> list:
    """Each client's requests, ``(kind, x)``: 1-300 rows each, the kinds in
    turn: host f32 (for ``submit``), host int8 and int8 already on the
    card (for ``submit_quantized``); the first client's first request has
    ``big`` rows when given."""
    g = model.graph
    out = []
    for c in range(clients):
        reqs = []
        for k in range(per_client):
            n = big if big and c == 0 and k == 0 else int(rng.integers(1, 301))
            kind = kinds[(c + k) % len(kinds)]
            if kind == "f32":
                x = rng.uniform(0, 1, (n, *g.input_shape)).astype(np.float32)
            else:
                x = rng.integers(-128, 128, (n, *g.input_shape), dtype=np.int8)
                if kind == "int8_device":
                    x = torch.from_numpy(x).to(dev)
            reqs.append((kind, x))
        out.append(reqs)
    return out


def serve_load(server, requests: list) -> tuple[list, float]:
    """One thread a client, each submitting its requests back to back and
    then waiting for them; returns ``[(kind, x, result)]`` and the wall
    seconds from the first submission to the last result."""
    import threading

    results = [[] for _ in requests]
    errors = []

    def client(i):
        try:
            futs = [server.submit(x) if kind == "f32" else server.submit_quantized(x)
                    for kind, x in requests[i]]
            results[i] = [(kind, x, f.result(timeout=300))
                          for (kind, x), f in zip(requests[i], futs)]
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"a client failed: {errors}")
    return [r for rs in results for r in rs], wall


def drained(server, n_requests: int) -> dict:
    """The server's counters once every request is accounted for (the
    worker counts a batch just after it resolves its futures)."""
    for _ in range(600):
        st = server.stats()
        if st["requests_completed"] + st["requests_failed"] >= n_requests:
            return st
        time.sleep(0.01)
    raise AssertionError(f"the server did not account for {n_requests} requests: {st}")


def serve_model(name: str, rng, dev, clients: int, per_client: int, big: int | None,
                warm: tuple, per_batch: dict, kinds=SERVE_KINDS) -> dict:
    """``name`` through a ``BatchServer`` on the default backend and mesh:
    warm, load, counters and launches, every result against
    ``predict_inner`` on its rows, the golden through the server."""
    from microflow_tpu_torch.core.quantize import dequantize
    from microflow_tpu_torch.parallel import BatchServer

    model = compile_tflite(model_path(name), name=name)
    forwards = []  # the batch of every forward the replica runs
    forward = model._forward

    def counted(xq):
        forwards.append(xq.shape[0])
        return forward(xq)

    model._forward = counted
    server = BatchServer(model, max_batch=SERVE_MAX_BATCH)
    try:
        t = time.perf_counter()
        for bucket in warm:
            server.warm(bucket)
        warm_s = time.perf_counter() - t
        requests = serve_requests(model, rng, dev, clients, per_client, big, kinds)
        n_requests = sum(len(r) for r in requests)
        torch.cuda.synchronize()
        forwards.clear()
        LAUNCHES.clear()
        served, wall = serve_load(server, requests)
        st = drained(server, n_requests)
        torch.cuda.synchronize()
        launches, batches = dict(LAUNCHES), list(forwards)
        golden_out = server.submit(GOLDENS[name][0]).result(timeout=300)
    finally:
        server.stop()
        model._forward = forward
    if server._thread.is_alive():
        raise AssertionError(f"{name}: the server's worker did not stop")
    rows = sum(x.shape[0] for _, x, _ in served)
    want_launches = {k: v * st["batches_dispatched"] for k, v in per_batch.items()}
    buckets = sorted(set(batches))
    accounts = {
        "requests_submitted": n_requests, "requests_completed": n_requests,
        "requests_failed": 0, "inferences_completed": rows,
        "batches_dispatched": len(batches), "rows_padded": sum(batches) - rows,
        "queue_depth": 0}
    bad = {k: (st[k], v) for k, v in accounts.items() if st[k] != v}
    if bad or launches != want_launches or any(b & (b - 1) or b > SERVE_MAX_BATCH
                                               for b in buckets):
        raise AssertionError(f"{name}: stats {st} (off: {bad}), launches {launches} (expected "
                             f"{want_launches}), forward batches {buckets}")
    g = model.graph
    worst = 0
    for kind, x, got in served:
        xq = model.quantize_input(x) if kind == "f32" else torch.as_tensor(x).to(dev)
        want = dequantize(model.predict_inner(xq), g.output_q.scale0, g.output_q.zp0).cpu()
        if got.device.type != "cpu" or got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{name}: a {kind} request of {x.shape[0]} rows came back "
                                 f"{got.dtype} {tuple(got.shape)} on {got.device}")
        worst = max(worst, max_abs_err(got, want))
    gold = golden_out.numpy()
    if worst or not np.array_equal(gold, GOLDENS[name][1]):
        raise AssertionError(f"{name}: served outputs differ from predict_inner by {worst}; "
                             f"golden {gold}")
    return {"backend": model.backend, "mesh": server.mesh.shape, "max_batch": SERVE_MAX_BATCH,
            "warm": list(warm), "warm_seconds": warm_s, "warmed": sorted(server._warmed),
            "requests": n_requests, "kinds": {k: sum(kind == k for kind, _, _ in served)
                                              for k in SERVE_KINDS},
            "largest_request": max(x.shape[0] for _, x, _ in served), "rows": rows,
            "stats": st, "launches": launches, "forward_batches": buckets,
            "served_vs_predict_inner_max_abs_err": worst, "golden": gold.ravel().tolist(),
            "wall_seconds": wall, "inferences_per_s": rows / wall}


REBUILD_CHECK = r"""
import json, sys
from microflow_tpu_torch import compile_tflite, native
from microflow_tpu_torch.models import GOLDENS, model_path
from microflow_tpu_torch.parallel import BatchServer

m = compile_tflite(model_path("person_detect"), name="person_detect")
s = BatchServer(m, max_batch=1024)
try:
    s.warm(64)
    got = s.submit(GOLDENS["person_detect"][0]).result(timeout=300)
finally:
    s.stop()
print(json.dumps({"backend": m.backend, "native": native.available(),
                  "golden": got.numpy().ravel().tolist(), "stats": s.stats()}))
"""


def libraries() -> dict:
    """mtime of every built library under ``build/torch_ext/`` and
    ``build/native/``."""
    out = {}
    for sub in ("torch_ext", "native"):
        d = os.path.join(ROOT, "build", sub)
        for f in sorted(os.listdir(d)):
            if f.endswith(".so"):
                out[f"{sub}/{f}"] = os.stat(os.path.join(d, f)).st_mtime_ns
    return out


def no_rebuild_check() -> dict:
    """A second process serves person_detect with ``CUDA_HOME`` pointing
    nowhere, so any ``nvcc`` call would fail; the libraries keep their
    mtimes."""
    before = libraries()
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", REBUILD_CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"the second process exited {out.returncode}: {out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    after = libraries()
    if (after != before or not line["native"] or line["backend"] != "flat"
            or line["golden"] != GOLDENS["person_detect"][1].ravel().tolist()
            or line["stats"]["requests_failed"]):
        raise AssertionError(f"second process: {line}; libraries before {before}, after {after}")
    return {"child": line, "libraries_unchanged": sorted(after)}


def serve_checks(dev, rng, smi: str) -> dict:
    """Phase 9: the native front end, person_detect and sine served through
    ``BatchServer`` on the default backend, and a second process that
    serves without building."""
    t = time.time()
    res = {"front_end": front_end_checks()}
    pd = serve_model("person_detect", rng, dev, SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_BIG,
                     warm=(64, SERVE_MAX_BATCH), per_batch={"flatpack": 1})
    m = compile_tflite(model_path("person_detect"), name="person_detect")
    xq = random_input(m, SERVE_MAX_BATCH, rng)
    ms = time_ms(lambda: m.predict_inner(xq), 20, warmup=2)
    pd["predict_inner_at_max_batch"] = {"batch": SERVE_MAX_BATCH, "ms_per_batch": ms,
                                        "inferences_per_s": SERVE_MAX_BATCH / ms * 1e3}
    res["person_detect"] = pd
    # the same load with every request already on the card: no request
    # bytes cross the host link inside the timed window
    res["person_detect_device_requests"] = serve_model(
        "person_detect", rng, dev, SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_BIG,
        warm=(64, SERVE_MAX_BATCH), per_batch={"flatpack": 1}, kinds=("int8_device",))
    res["sine"] = serve_model("sine", rng, dev, 4, SERVE_PER_CLIENT, None, warm=(64,),
                              per_batch={"qgemm": 3})
    res["second_process"] = no_rebuild_check()
    res["device"] = smi
    res["seconds"] = round(time.time() - t, 1)
    return res


# --- phases -------------------------------------------------------------------


# --- the tensor-parallel step and the two-process tier (phase 10) -----------

WORKER = os.path.join(ROOT, "scripts", "torch_multiprocess_worker.py")
WORKER_TIMEOUT_S = 300


def sharded_speech_checks(dev, batch: int = 256, steps: int = 3) -> dict:
    """``ShardedTrainer`` on speech through ``"pallas"`` on meshes that
    repeat the card (``[2, 2]``, ``[1, 2]``: the FC row-sharded over
    ``model``): ``steps`` steps and an update beside a replicated
    ``"pallas"`` and ``"xla"`` trainer; outputs, grads after every step and
    params after the update bit-equal.  Returns each mesh's launches a
    step (a ``qdwconv`` and a ``qsoftmax`` a cell: the depthwise layer and
    the softmax; the sharded FC is the plain integer product)."""
    out = {}
    for shape in ((2, 2), (1, 2)):
        mesh = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        tr = ShardedTrainer(trainer("speech", "pallas", "quantized", dev), mesh)
        if tr.params["layer2"]["weights"].spec != ("model", None):
            raise AssertionError("speech's FC is not row-sharded")
        mp, mx = (trainer("speech", b, "quantized", dev) for b in ("pallas", "xla"))
        gen = torch.Generator().manual_seed(18)
        launches, nonzero = [], []
        for step in range(steps):
            xq, gt = train_batch(mp, batch, gen)
            LAUNCHES.clear()
            y = tr.predict_quantized_train(xq, gt)
            torch.cuda.synchronize(dev)
            launches.append(dict(LAUNCHES))
            for m in (mp, mx):
                if not torch.equal(y, m.predict_quantized_train(xq, gt)):
                    raise AssertionError(f"{shape}: the sharded output differs, step {step}")
                _same_state(tr.gather()[1], m.grads, f"{shape} grads after step {step}")
            nonzero.append(int(mp.grads["layer2"]["weights_gradient"].count_nonzero()))
        if not nonzero[-1]:
            raise AssertionError(f"{shape}: no gradient reached the sharded FC")
        for m in (tr, mp, mx):
            m.update_layers(batch, TRAIN_LR)
        for m in (mp, mx):
            _same_state(tr.gather()[0], m.params, f"{shape} params after the update")
        want = {"qdwconv": shape[0] * shape[1], "qsoftmax": shape[0] * shape[1]}
        if any(n != want for n in launches):
            raise AssertionError(f"{shape}: a sharded step launched {launches}, expected {want}")
        out[f"{shape[0]}x{shape[1]}"] = {"launches_per_step": launches[0],
                                         "nonzero_fc_gradient_after_each_step": nonzero}
    return out


def sharded_fold_check(dev, batch: int = 256) -> dict:
    """person_detect_trainable(10) through ``"pallas"`` on a ``[4, 1]`` mesh
    of the card (data only): a step, then with an accumulator at -2**31 +
    10 a step on the serial saturating fold (the batch's gradients gathered
    in order), and an update, bit-equal to one device."""
    tr = ShardedTrainer(trainer("person_detect", "pallas", "quantized", dev),
                        make_mesh(4, 1, devices=[dev] * 4))
    one = trainer("person_detect", "pallas", "quantized", dev)
    gen = torch.Generator().manual_seed(19)
    key = next(k for k, v in one.grads.items() if v["weights_gradient"].dim() == 4)
    bounds = []
    for step in range(2):
        if step == 1:
            one.grads[key]["weights_gradient"].fill_(-2**31 + 10)
            for c in tr.cells:
                tr.grads[key]["weights_gradient"].shards[c].fill_(-2**31 + 10)
        xq, gt = train_batch(one, batch, gen)
        if not torch.equal(tr.predict_quantized_train(xq, gt),
                           one.predict_quantized_train(xq, gt)):
            raise AssertionError(f"person_detect [4, 1]: the output differs, step {step}")
        bounds.append(tr._fold_bound)
        _same_state(tr.gather()[1], one.grads, f"person_detect [4, 1] grads after step {step}")
    positive = int((one.grads[key]["weights_gradient"] > 0).sum())
    if bounds[1] != 2**31 or positive:
        raise AssertionError(f"the serial fold did not run or wrapped: bounds {bounds}, "
                             f"{positive} positive entries")
    tr.update_layers(batch, TRAIN_LR)
    one.update_layers(batch, TRAIN_LR)
    _same_state(tr.gather()[0], one.params, "person_detect [4, 1] params after the update")
    return {"layer": key, "fold_bounds": bounds, "positive_entries_after_serial_fold": positive}


def run_workers(mode: str, backend: str, *extra) -> list[dict]:
    """Both ranks of ``scripts/torch_multiprocess_worker.py`` on the card
    (rank i on ``cuda:<i % count>``), started together, rendezvous in a
    fresh file under ``build/``; each must exit 0 within
    ``WORKER_TIMEOUT_S`` and print ``proc <i>: OK``.  Returns their JSON
    lines."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rdv", dir=os.path.join(ROOT, "build"))
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, f"file://{tmp}/rdv", "2", str(i), mode, "--device", "cuda",
         "--backend", backend, *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{mode}/{backend}: a rank ran past {WORKER_TIMEOUT_S} s")
    lines = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"proc {i}: OK" not in out:
            raise AssertionError(f"{mode}/{backend} rank {i} failed ({p.returncode}):\n"
                                 f"{out[-3000:]}")
        lines.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    return lines


def two_process_checks() -> dict:
    """The two-process tier on the card, both ranks on ``cuda:0`` under
    gloo: ``train_tp`` (speech through ``"pallas"``), and one ``infer`` run
    (a start-up and rendezvous for both models) of sine through
    ``"pallas"`` and person_detect through ``"flat"`` at 2 x 4096 rows (one
    ``flatpack`` launch a rank and local chunk); NCCL too, a card a rank,
    where there are two cards."""
    res = {}
    runs = [("gloo", "train_tp", ("--model-backend", "pallas"), {"qdwconv": 4, "qsoftmax": 4}),
            ("gloo", "infer", ("--model", "sine", "person_detect", "--model-backend", "pallas",
                               "flat", "--rows", "32", "8192"),
             {"sine": {"qgemm": 3}, "person_detect": {"flatpack": 1}})]
    if torch.cuda.device_count() >= 2:
        runs += [("nccl", mode, args, want) for _, mode, args, want in runs]
    else:
        res["nccl"] = f"not run: {torch.cuda.device_count()} CUDA device"
    for backend, mode, args, want in runs:
        t = time.time()
        lines = run_workers(mode, backend, *args)
        label = f"{backend}/{mode}"
        if any(ln["launches"] != want for ln in lines):
            raise AssertionError(f"{label}: launches {[ln['launches'] for ln in lines]}, "
                                 f"expected {want} a rank")
        res[label] = {"seconds": round(time.time() - t, 1), "ranks": [
            {k: v for k, v in ln.items() if k not in ("mode", "dist_backend")} for ln in lines]}
    return res


def time_sharded_step(dev, smi: str, batch: int = 1024) -> dict:
    """ms a speech train step through ``"pallas"``: ``ShardedTrainer`` on a
    ``[2, 2]`` mesh of the card against the replicated trainer, in turns
    (sharded, replicated, replicated, sharded), CUDA events around 5 steps
    after 2 warm-up steps; printed, not gated."""
    tr = ShardedTrainer(trainer("speech", "pallas", "quantized", dev),
                        make_mesh(2, 2, devices=[dev] * 4))
    one = trainer("speech", "pallas", "quantized", dev)
    xq, gt = train_batch(one, batch, torch.Generator().manual_seed(20))
    runs = {"sharded_2x2": [], "replicated": []}
    for name in ("sharded_2x2", "replicated", "replicated", "sharded_2x2"):
        m = tr if name == "sharded_2x2" else one
        runs[name].append(time_ms(lambda: m.predict_quantized_train(xq, gt), 5, warmup=2))
    return {"model": "speech_trainable", "batch": batch, "device": smi, "step_ms": runs}


@contextlib.contextmanager
def captured(*names):
    """Every call of ``kernels/<name>.py``'s ``<name>`` while the block runs,
    as name -> [(args, kw)]; the kernels still run."""
    mods = {n: sys.modules[f"microflow_tpu_torch.kernels.{n}"] for n in names}
    orig = {n: getattr(mods[n], n) for n in names}
    calls = {n: [] for n in names}

    def wrap(n):
        def call(*args, **kw):
            calls[n].append((args, kw))
            return orig[n](*args, **kw)

        return call

    for n in names:
        setattr(mods[n], n, wrap(n))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(mods[n], n, fn)


def time_elementwise(name: str, calls: list, moved) -> dict:
    """``qadd`` or ``qsoftmax`` at each captured call: bit-equal to its plain
    version on the card, ms beside the plain version's and beside the bound
    (``moved(args)`` bytes at HBM rate); sums over the calls.  No single
    PyTorch call computes TFLite's integer ADD or this row-ordered softmax,
    so neither has ``library_ms``."""
    import microflow_tpu_torch.kernels.qadd as qadd_module
    import microflow_tpu_torch.kernels.qsoftmax as qsoftmax_module

    module = {"qadd": qadd_module, "qsoftmax": qsoftmax_module}[name]
    kern, ref = getattr(module, name), getattr(module, f"{name}_reference")
    rows = []
    for args, kw in calls:
        nbytes = moved(args)
        rows.append({"shape": list(args[0].shape),
                     "max_abs_err": max_abs_err(kern(*args, **kw), ref(*args, **kw)),
                     "ms": time_ms(lambda: kern(*args, **kw), 20),
                     "plain_ms": time_ms(lambda: ref(*args, **kw), 3, warmup=1),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes})
    return {"ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
            "library_ms": None, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "launches_per_forward": len(rows), "per_call": rows}


def residual_checks(dev, rng, smi: str) -> dict:
    """MobileNetV2 (``MOBILENET``) through ``compile_tflite``'s default
    backend, which must be ``"pallas"``: two requests (batch 1024, then 3)
    with the launch counts set to 0 just before, ``MOBILENET_FORWARD``
    launches a forward; the batch-3 output bit-equal to ``"xla"`` on the
    card.  Each ``qadd`` and the ``qsoftmax`` call of the batch-1024
    forward, bit-equal to its plain version on the card and timed
    (``time_elementwise``: 3 bytes an element for ``qadd``, 2 for
    ``qsoftmax``).  Then ``qsoftmax`` beside the plain op at 2 to 1001
    classes, call ms (printed, not gated)."""
    import microflow_tpu_torch.kernels.qadd  # noqa: F401  (for ``captured``)
    import microflow_tpu_torch.kernels.qsoftmax as qsoftmax_module

    m = compile_tflite(MOBILENET)
    if m.backend != "pallas":
        raise AssertionError(f"default backend on CUDA for MobileNetV2 is {m.backend!r}")
    small = random_input(m, 3, rng)
    LAUNCHES.clear()
    with captured("qadd", "qsoftmax") as calls:
        m.predict_inner(random_input(m, 1024, rng))
        y = m.predict_inner(small)
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches != {k: 2 * n for k, n in MOBILENET_FORWARD.items()}:
        raise AssertionError(f"MobileNetV2 launched {launches}, expected {MOBILENET_FORWARD} "
                             "a forward (2 requests)")
    xla_err = max_abs_err(y, compile_tflite(MOBILENET, backend="xla").predict_inner(small))
    if xla_err:
        raise AssertionError(f"MobileNetV2 through pallas is {xla_err} from xla at batch 3")
    timed = {
        "qadd": time_elementwise("qadd", calls["qadd"][:MOBILENET_FORWARD["qadd"]],
                                 lambda a: 3 * a[0].numel()),
        "qsoftmax": time_elementwise("qsoftmax", calls["qsoftmax"][:1],
                                     lambda a: 2 * a[0].numel())}
    del calls, m
    torch.cuda.empty_cache()
    if any(t["max_abs_err"] for t in timed.values()):
        raise AssertionError(f"qadd or qsoftmax differs from its plain version: {timed}")
    widths = []
    for n in (2, 4, 12, 128, 1001):
        for rows in (1024, 65536):
            x = torch.randint(-128, 128, (rows, n), device=dev, dtype=torch.int8)
            kw = dict(in_scale=0.0913, out_scale=1 / 256.0, out_zp=-128)
            widths.append({"classes": n, "rows": rows,
                           "qsoftmax_ms": time_ms(lambda: qsoftmax_module.qsoftmax(x, **kw), 20),
                           "plain_ms": time_ms(lambda: qsoftmax_module.qsoftmax_reference(
                               x, **kw), 20 if n < 1001 else 3, warmup=1)})
    return {"backend": "pallas", "launches": launches, "requests": 2, "vs_xla_batch3": xla_err,
            "batch": 1024, **timed, "softmax_by_width": widths, "device": smi}


def distributed_checks(dev, smi: str) -> dict:
    t = time.time()
    res = {"sharded_speech": sharded_speech_checks(dev),
           "sharded_fold": sharded_fold_check(dev)}
    torch.cuda.empty_cache()
    res["two_process"] = two_process_checks()
    res["timing"] = time_sharded_step(dev, smi)
    res["seconds"] = round(time.time() - t, 1)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.time()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t = time.time()
    paths = build.build_all()
    ptxas, usage = {}, {}
    for name, path in paths.items():
        with open(path + ".log") as f:
            log = f.read().splitlines()
        ptxas[name] = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
        usage.update(ptxas_usage(log))
    emit({"phase": "build", "seconds": round(time.time() - t, 3), "ptxas": ptxas,
          "ptxas_by_function": usage})
    # the exact2 flat kernel, the megakernel and the packed kernel keep their
    # budget: no stack, no spills within __launch_bounds__(256, 4)'s 64
    # registers
    for key in ("flat_kernelILi0E", "segment_kernel", "packed_kernel"):
        (fn,) = [u for f, u in usage.items() if key in f]
        if fn["registers"] > 64 or fn["stack"] or fn["spill_stores"] or fn["spill_loads"]:
            raise AssertionError(f"{key}: {fn}")
    # qgemm's tensor-core and narrow-path instantiations and colfc: no stack,
    # no spills
    for f, fn in usage.items():
        if (("qgemm_mma" in f or "qgemm_rows" in f or "col_kernel" in f)
                and (fn["stack"] or fn["spill_stores"] or fn["spill_loads"])):
            raise AssertionError(f"{f}: {fn}")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    with Recorder("check") as rec:
        for name in MODELS:
            m = compile_tflite(model_path(name), name=name, backend="pallas")
            m.predict_inner(random_input(m, 64, rng))
    shape_errs = rec.calls
    edge = edge_cases(dev, rng)
    whole_net = whole_network_checks(dev, rng)
    torch.cuda.synchronize()
    checks = {k: shape_errs[k] + edge[k] for k in shape_errs}
    checks.update(whole_net["checks"])
    errs = {k: max(c["max_abs_err"] for c in v) for k, v in checks.items()}
    emit({"phase": "kernels_vs_plain", "tolerance": "bit-equal (max_abs_err 0)",
          "max_abs_err": errs, "checks": {k: len(v) for k, v in checks.items()},
          "model_shapes": {k: len(shape_errs[k]) for k in shape_errs},
          "qgemm_checks_by_path": {p: sum(c.get("path", c.get("shape", {}).get("path")) == p
                                          for c in checks["qgemm"]) for p in QGEMM_PATHS},
          "whole_network_cases": {k: [c["case"] for c in v]
                                  for k, v in whole_net["checks"].items()},
          "fma_sensitive_lanes": whole_net["fma_sensitive_lanes"],
          "exact2_corner_lanes": whole_net["exact2_corner_lanes"],
          "fixed_edge_counts": whole_net["fixed_edge_counts"],
          "mode_edge_counts": whole_net["mode_edge_counts"],
          "flatpack_mma_sync_ops": whole_net["mma_ops"],
          "flatpack_3x3_depthwise_ops": whole_net["dw3_ops"],
          "megakernel_paths": whole_net["mega_paths"],
          "packed_paths": whole_net["packed_paths"],
          "packed_edge_paths": whole_net["packed_edge_paths"],
          "packed_exact2_corner_outputs": whole_net["packed_exact2_corner_outputs"]})
    if any(errs.values()):
        bad = [c for v in checks.values() for c in v if c["max_abs_err"]][:20]
        raise AssertionError(f"kernel differs from its plain version: {errs}; {bad}")

    pd = compile_tflite(model_path("person_detect"), name="person_detect", backend="pallas")
    with Recorder("capture") as rec:
        pd.predict_inner(random_input(pd, 8192, rng))
    torch.backends.cudnn.allow_tf32 = False  # the depthwise yardstick in exact f32
    timing = time_kernels(rec.calls)
    del rec
    torch.cuda.empty_cache()
    # sine's three qgemm shapes, at the batch colfc is timed at
    sine = compile_tflite(model_path("sine"), name="sine", backend="pallas")
    with Recorder("capture") as rec:
        sine.predict_inner(random_input(sine, 1 << 20, rng))
    if [(a[0].shape[1], a[1].shape[1]) for a, _ in rec.calls["qgemm"]] != list(SINE_QGEMM):
        raise AssertionError("sine's qgemm shapes are not SINE_QGEMM")
    timing["qgemm_sine"] = time_kernels(rec.calls)["qgemm"]
    del rec, sine
    torch.cuda.empty_cache()
    timing_whole = time_whole_network(dev, rng)
    torch.cuda.empty_cache()
    sine_times = time_sine(dev, rng)
    if any(v["max_abs_err"] for v in list(timing.values()) + list(timing_whole.values())
           + [r[k] for r in sine_times.values() for k in ("colfc", "flat", "pallas")]):
        raise AssertionError("kernel differs from its plain version at the timed batch")
    if not timing_whole["flatpack_exact_packed_layers"]["equal_to_packed"]:
        raise AssertionError("the flat kernel in exact mode differs from packed on its layers")
    emit({"phase": "kernel_times", "batch": 8192, "device": smi, **timing, **timing_whole,
          "sine_by_batch": sine_times})

    # 4. main paths, each with the launch counts set to 0 just before it
    def drive(model, requests):
        LAUNCHES.clear()
        outs = [model.predict(r) for r in requests]
        torch.cuda.synchronize()
        if not all(np.isfinite(o.cpu().numpy()).all() for o in outs):
            raise AssertionError(f"{model.graph.name}: non-finite output")
        return outs, dict(LAUNCHES)

    def golden(name, got):
        want = GOLDENS[name][1]
        got = got.cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name} golden mismatch: {got} != {want}")
        return got.ravel().tolist()

    pd_reqs = [GOLDENS["person_detect"][0]] + [
        rng.uniform(0, 1, (b, 96, 96, 1)).astype(np.float32) for b in (1, 3, 16)]
    goldens, paths = {}, {}
    for name in MODELS:
        m = compile_tflite(model_path(name), name=name)
        expect = "pallas" if name == "sine" else "flat"
        if m.backend != expect:
            raise AssertionError(f"default backend on CUDA for {name} is {m.backend!r}, "
                                 f"not {expect!r}")
        if name == "person_detect":
            outs, paths["flat"] = drive(m, pd_reqs)
            goldens[name] = golden(name, outs[0])
        else:
            goldens[name] = golden(name, m.predict(GOLDENS[name][0]))
    if paths["flat"] != {"flatpack": 4}:
        raise AssertionError(f"default person_detect path launched {paths['flat']}, "
                             "expected 4 flatpack launches and no per-op kernel (4 requests)")
    m = compile_tflite(model_path("person_detect"), name="person_detect", backend="pallas")
    outs, paths["pallas"] = drive(m, pd_reqs)
    golden("person_detect", outs[0])
    if paths["pallas"] != {k: 4 * n for k, n in PD_FORWARD.items()}:
        raise AssertionError(f"pallas path launched {paths['pallas']}, expected "
                             f"{PD_FORWARD} per forward (4 requests)")
    m = compile_tflite(model_path("sine"), name="sine", backend="colfc")
    sine_reqs = [GOLDENS["sine"][0]] + [
        rng.uniform(0, 2 * np.pi, (b, 1)).astype(np.float32) for b in (1, 3, 1000)]
    outs, paths["colfc"] = drive(m, sine_reqs)
    golden("sine", outs[0])
    if paths["colfc"] != {"colfc": 4}:
        raise AssertionError(f"colfc path launched {paths['colfc']}, expected 4 (4 requests)")
    for backend, want in PD_PATHS.items():
        m = compile_tflite(model_path("person_detect"), name="person_detect", backend=backend)
        outs, paths[backend] = drive(m, pd_reqs)
        goldens[f"person_detect/{backend}"] = golden("person_detect", outs[0])
        if paths[backend] != want:
            raise AssertionError(f"{backend} path launched {paths[backend]}, expected {want} "
                                 "(4 requests)")
        if backend != "packed":
            for name in ("sine", "speech"):
                m = compile_tflite(model_path(name), name=name, backend=backend)
                goldens[f"{name}/{backend}"] = golden(name, m.predict(GOLDENS[name][0]))
    m = compile_tflite(model_path("speech"), name="speech", backend="fused")
    speech_reqs = [GOLDENS["speech"][0]] + [
        rng.uniform(0, 1, (b, 1960)).astype(np.float32) for b in (1, 3, 16)]
    outs, paths["fused/speech"] = drive(m, speech_reqs)
    golden("speech", outs[0])
    if paths["fused/speech"] != {"megakernel": 8}:
        raise AssertionError(f"fused speech path launched {paths['fused/speech']}, expected 2 "
                             "megakernel launches a forward (4 requests)")
    # the fixed-point epilogue, through the builder's door to it (as in the
    # JAX package): the 4 person_detect requests (their distance from xla is
    # printed: on image-like inputs the (M, S) form reaches 4 LSB, as the JAX
    # kernel's own bits do); then the JAX package's gate for the mode
    # (tests/test_flatpack.py: its 8 random int8 samples, from seed 17,
    # within 2 LSB of xla)
    with flat_requant("fixed"):
        m = compile_tflite(model_path("person_detect"), name="person_detect", backend="auto")
    outs, paths["auto/fixed"] = drive(m, pd_reqs)
    if paths["auto/fixed"] != {"flatpack_fixed": 4}:
        raise AssertionError(f"fixed person_detect path launched {paths['auto/fixed']}, "
                             "expected 4 launches of the fixed flat kernel and no other")
    mx = compile_tflite(model_path("person_detect"), name="person_detect", backend="xla")
    scale = float(mx.graph.output_q.scale0)
    request_lsb = [int(torch.round((o - mx.predict(r)).abs().max() / scale).item())
                   for o, r in zip(outs, pd_reqs)]
    xg = torch.from_numpy(np.random.default_rng(17).integers(-128, 128, (8, 96, 96, 1),
                                                             dtype=np.int8)).to(dev)
    fixed_lsb = int((m.predict_inner(xg).to(torch.int32)
                     - mx.predict_inner(xg).to(torch.int32)).abs().max().item())
    if fixed_lsb > 2:
        raise AssertionError(f"fixed person_detect is {fixed_lsb} LSB from xla on the JAX "
                             "package's gate samples (gate: 2)")
    # the measurement-only modes through the same door: 4 launches of their
    # own instantiation each and no other kernel, finite outputs (not exact)
    for mode in ("raw", "noround"):
        with flat_requant(mode):
            mm = compile_tflite(model_path("person_detect"), name="person_detect", backend="auto")
        _, paths[f"auto/{mode}"] = drive(mm, pd_reqs)
        if paths[f"auto/{mode}"] != {f"flatpack_{mode}": 4}:
            raise AssertionError(f"{mode} person_detect path launched {paths[f'auto/{mode}']}, "
                                 f"expected 4 launches of flat_kernel<{mode}> and no other")
    launches = {"qgemm": paths["pallas"]["qgemm"], "qdwconv": paths["pallas"]["qdwconv"],
                "flatpack": paths["flat"]["flatpack"], "colfc": paths["colfc"]["colfc"],
                "megakernel": paths["fused"]["megakernel"], "packed": paths["packed"]["packed"],
                "flatpack_fixed": paths["auto/fixed"]["flatpack_fixed"],
                "flatpack_raw": paths["auto/raw"]["flatpack_raw"],
                "flatpack_noround": paths["auto/noround"]["flatpack_noround"]}
    emit({"phase": "main_path", "goldens_bit_exact": goldens, "launches_by_path": paths,
          "requests": 4, "fixed_requests_vs_xla_lsb": request_lsb,
          "fixed_gate_samples_vs_xla_lsb": fixed_lsb, "fixed_gate_lsb": 2})

    # 5. whole model: the kernel backends vs the plain torch ops on the card
    whole, fixed_whole = {}, {}
    for name in MODELS:
        mx = compile_tflite(model_path(name), name=name, backend="xla")
        xq = random_input(mx, 1024, rng)
        yx = mx.predict_inner(xq)
        extra = {"sine": ("colfc",), "person_detect": ("packed",)}.get(name, ())
        for backend in ("flat", "pallas", "fused", "hybrid") + extra:
            yk = compile_tflite(model_path(name), name=name, backend=backend).predict_inner(xq)
            whole[f"{name}/{backend}"] = {"shape": list(yk.shape),
                                          "max_abs_err": max_abs_err(yk, yx)}
        if name != "sine":
            # flat + fixed against its plain version; its distance from xla
            # is printed, not gated
            with flat_requant("fixed"):
                mf = compile_tflite(model_path(name), name=name, backend="flat")
            yk = mf.predict_inner(xq)
            fn, _, _ = build_flat_kernel(mf.graph, requant="fixed", device=dev)
            ref = flat_forward_reference(fn.ops, xq.reshape(xq.shape[0], -1), "fixed")
            dev_xla = (yk.to(torch.int32) - yx.to(torch.int32)).abs()
            fixed_whole[f"{name}/flat+fixed"] = {
                "shape": list(yk.shape), "max_abs_err": max_abs_err(yk.reshape(ref.shape), ref),
                "vs_xla_max_lsb": int(dev_xla.max().item()),
                "vs_xla_outputs_differing": int((dev_xla > 0).sum().item()),
                "outputs": int(dev_xla.numel())}
        del mx
    torch.cuda.empty_cache()
    emit({"phase": "whole_model_vs_plain", "batch": 1024, **whole, **fixed_whole})
    if any(v["max_abs_err"] for v in list(whole.values()) + list(fixed_whole.values())):
        raise AssertionError(f"a kernel backend differs from the plain backend: {whole} "
                             f"{fixed_whole}")

    # 6. throughput, flat and pallas in turns on one card
    thr = {}
    for name, batches in (("person_detect", (8192, 32768)), ("speech", (8192,))):
        models = {b: compile_tflite(model_path(name), name=name, backend=b)
                  for b in ("flat", "pallas")}
        for batch in batches:
            xq = random_input(models["flat"], batch, rng)
            runs = {"flat": [], "pallas": []}
            for backend in ("flat", "pallas", "pallas", "flat"):
                mb = models[backend]
                runs[backend].append(time_ms(lambda: mb.predict_inner(xq),
                                             10 if batch == 8192 else 5, warmup=2))
            thr[f"{name}/{batch}"] = {b: {"ms_per_batch": v, "inferences_per_s": [
                batch / ms * 1e3 for ms in v]} for b, v in runs.items()}
            del xq
            torch.cuda.empty_cache()
    del models
    # the flat kernel's exact2 and fixed epilogues in turns
    with flat_requant("fixed"):
        fixed_model = compile_tflite(model_path("person_detect"), name="person_detect",
                                     backend="flat")
    models = {"exact2": compile_tflite(model_path("person_detect"), name="person_detect",
                                       backend="flat"), "fixed": fixed_model}
    xq = random_input(models["exact2"], 8192, rng)
    runs = {"exact2": [], "fixed": []}
    for mode in ("exact2", "fixed", "fixed", "exact2"):
        mb = models[mode]
        runs[mode].append(time_ms(lambda: mb.predict_inner(xq), 10, warmup=2))
    thr["person_detect/8192/flat_requant"] = {k: {"ms_per_batch": v, "inferences_per_s": [
        8192 / ms * 1e3 for ms in v]} for k, v in runs.items()}
    del models, fixed_model, xq
    for backend in ("fused", "hybrid", "packed"):
        mb = compile_tflite(model_path("person_detect"), name="person_detect", backend=backend)
        xq = random_input(mb, 8192, rng)
        ms = time_ms(lambda: mb.predict_inner(xq), 10, warmup=2)
        thr[f"person_detect/8192/{backend}"] = {"ms_per_batch": ms,
                                                "inferences_per_s": 8192 / ms * 1e3}
        del xq
    torch.cuda.empty_cache()
    emit({"phase": "throughput", "order": "flat, pallas, pallas, flat; then person_detect's flat "
          "exact2, fixed, fixed, exact2; then fused, hybrid, packed",
          "device": smi, "clocks_power": nvidia_smi("clocks.sm,power.draw,power.limit"), **thr})
    # 7. training: pallas against xla, bit for bit, then timed
    t = time.time()
    train = train_checks(dev)
    pd_step = train["person_detect/quantized"]["launches"]
    if (any(n != {**PD_FORWARD, **PD_BACKWARD} for n in pd_step["pallas"])
            or any(n != PD_BACKWARD for n in pd_step["xla"])):
        raise AssertionError(f"person_detect train steps launched {pd_step}, expected "
                             f"{PD_FORWARD} and {PD_BACKWARD} a step through pallas and "
                             f"{PD_BACKWARD} through xla")
    kinds = {case: res["steps"] for case, res in train.items()}
    if any(k != {"graph": 2, "eager": 1} for case in kinds.values() for k in case.values()):
        raise AssertionError(f"train steps {kinds}: expected the first eager and the other "
                             "two replayed as CUDA graphs, a case and backend")
    torch.cuda.empty_cache()
    wgrad = qwgrad_checks(dev, trainer("person_detect", "xla", "quantized", dev).graph)
    wgrad_step = wgrad_step_check(dev)
    torch.cuda.empty_cache()
    emit({"phase": "train", "batch": 256, "steps": 3, "lr": TRAIN_LR,
          "tolerance": "bit-equal (pallas vs xla: grads after every step, params after "
          "every update; qwgrad vs its plain version; the card's trainer vs the CPU's)",
          "cases": train, "person_detect_step_launches": pd_step["pallas"][0],
          "graph_and_eager_steps": kinds, "qwgrad": wgrad, "card_vs_cpu_steps": wgrad_step,
          "timing": time_training(dev, smi), "seconds": round(time.time() - t, 1)})
    torch.cuda.empty_cache()
    # 8. the user-facing entry points
    emit({"phase": "entry_points", "device": smi, **entry_points(dev, rng)})
    torch.cuda.empty_cache()
    # 9. serving, and the native front end
    emit({"phase": "serve", **serve_checks(dev, rng, smi)})
    torch.cuda.empty_cache()
    # 10. the tensor-parallel step and the two-process tier
    emit({"phase": "distributed", "tolerance": "bit-equal (outputs, grads, params)",
          **distributed_checks(dev, smi)})
    torch.cuda.empty_cache()
    # 11. MobileNetV2: the residual graph walk, qadd and qsoftmax
    residual = residual_checks(dev, rng, smi)
    launches.update(qadd=residual["launches"]["qadd"], qsoftmax=residual["launches"]["qsoftmax"],
                    qwgrad=pd_step["xla"][0]["qwgrad"])
    emit({"phase": "residual", "tolerance": "bit-equal (max_abs_err 0)", **residual})
    torch.cuda.empty_cache()
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})

    per_kernel = {**timing, "flatpack": timing_whole["flatpack_person_detect"],
                  "flatpack_fixed": timing_whole["flatpack_fixed_person_detect"],
                  "flatpack_raw": timing_whole["flatpack_raw_person_detect"],
                  "flatpack_noround": timing_whole["flatpack_noround_person_detect"],
                  "colfc": timing_whole["colfc_sine"],
                  "megakernel": timing_whole["megakernel_person_detect"],
                  "packed": timing_whole["packed_person_detect"],
                  "qadd": residual["qadd"], "qsoftmax": residual["qsoftmax"],
                  "qwgrad": wgrad}
    emit({"kernels": [
        {"name": k, "route": "cuda", **KERNEL_INFO[k], "launches": launches[k],
         "max_abs_err": max(errs.get(k, 0), per_kernel[k]["max_abs_err"]),
         "ms": per_kernel[k]["ms"],
         "plain_ms": per_kernel[k]["plain_ms"], "bound_ms": per_kernel[k]["bound_ms"],
         "bound_by": per_kernel[k]["bound_by"], "library_ms": per_kernel[k]["library_ms"]}
        for k in KERNEL_INFO]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
