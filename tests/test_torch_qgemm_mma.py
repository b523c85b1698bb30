"""``qgemm``'s tensor-core path (``qgemm_mma`` in
``microflow_tpu_torch/csrc/qgemm.cu``) emulated in numpy on the CPU
(``tests/torch_emulators.py::qgemm_mma``), and the rule that picks it
(``kernels/qgemm.py::qgemm_path``).

The emulator replays the kernel from ``[K, N]`` W and ``[M, K]`` X: the
block's fragment build (4x4 byte blocks of W transposed and stored at
their lane and register), each lane's B reads with the K permutation,
``mma.sync`` m16n8k32 by PTX's fragment tables, the row sums (``__dp4a``
against ones, the quad's and the pair's shuffles), the epilogue and the
stores (the 4x4 byte transpose over lanes).  Its output must equal
``qgemm_reference`` bit for bit, and the JAX package's Pallas ``qgemm``
(interpret mode) under the FMA rule of ``torch_parity.py``.  The card
runs the kernel itself in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp
import torch_emulators as te
from test_torch_cuda import gemm_case, torch_args

from microflow_tpu.core import FusedActivation as JAct
from microflow_tpu.kernels import qgemm as j_qgemm
from microflow_tpu_torch import compile_tflite
from microflow_tpu_torch.core import FusedActivation as TAct
from microflow_tpu_torch.core.activation import activation_bounds
from microflow_tpu_torch.kernels import flatpack as tflat
from microflow_tpu_torch.models import model_path

# the module (the package's ``qgemm`` attribute is the wrapper function)
tqgemm = importlib.import_module("microflow_tpu_torch.kernels.qgemm")

F32 = np.float32
# (M, K, N): K past a multiple of 32 or 64 and not a multiple of 4, N not a
# multiple of 16 (and below 4), M not a multiple of a work item, speech's FC
CASES = [(5, 64, 16), (17, 65, 11), (24, 130, 129), (9, 256, 2), (3, 4000, 4)]
# person_detect's 14 qgemm calls at batch 8192 (the 1x1 convs and the head)
PD_SHAPES = [(18874368, 8, 16), (4718592, 16, 32), (4718592, 32, 32), (1179648, 32, 64),
             (1179648, 64, 64), (294912, 64, 128)] + [(294912, 128, 128)] * 5 + \
            [(73728, 128, 256), (73728, 256, 256), (8192, 256, 2)]


def _case(M, K, N, seed=0):
    rng = np.random.default_rng(seed + M + K + N)
    return gemm_case(rng, M, K, N, rng.integers(-9, 9, N), in_zp=-7)


def _vec(K):
    """The B-read mode the entry point picks for an X at a 16-byte address."""
    return 2 if K % 16 == 0 else 1 if K % 4 == 0 else 0


@pytest.mark.parametrize("M,K,N", CASES)
@pytest.mark.parametrize("act", ["none", "relu6"])
def test_emulator_matches_reference_and_pallas(M, K, N, act):
    x, w, wzp, d, bias0, c1 = _case(M, K, N)
    kw = dict(out_scale=0.05, out_zp=4)
    lo, hi = activation_bounds(TAct(act), **kw)
    ref = tqgemm.qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), activation=TAct(act),
                                 **kw).numpy()
    got = te.qgemm_mma(x, w, wzp, d, bias0, c1, lo, hi, vec=_vec(K), vec_out=N % 4 == 0)
    assert np.array_equal(got, ref)
    jx = np.asarray(j_qgemm(*(jnp.asarray(a) for a in (x, w, wzp, d, bias0, c1)),
                            activation=JAct(act), **kw))
    q = x.astype(np.int64) @ w.astype(np.int64) - x.astype(np.int64).sum(1, keepdims=True) * wzp + d
    tp.assert_fma_rule(got, jx, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


@pytest.mark.parametrize("M,K,N,vec,vec_out", [
    (5, 64, 16, 1, True), (5, 64, 16, 0, False),      # X at a 4-byte, a 1-byte address
    (9, 256, 8, 0, True), (3, 4000, 4, 1, False),     # bytes; byte stores where N % 4 == 0
    (40, 100, 20, 1, True),                           # K % 16 != 0: words
])
def test_emulator_read_and_store_modes(M, K, N, vec, vec_out):
    x, w, wzp, d, bias0, c1 = _case(M, K, N, seed=1)
    kw = dict(activation=TAct.RELU, out_scale=0.03, out_zp=-5)
    ref = tqgemm.qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), **kw).numpy()
    lo, hi = activation_bounds(TAct.RELU, 0.03, -5)
    assert np.array_equal(te.qgemm_mma(x, w, wzp, d, bias0, c1, lo, hi, vec, vec_out), ref)


@pytest.mark.parametrize("K,N", [(64, 16), (65, 11), (130, 129), (256, 256), (4000, 4)])
def test_fragment_build_is_mma_fragments(K, N):
    """The block's build from [K, N] W stores each chunk of output channels
    in ``kernels/flatpack.py::mma_fragments``' order, rows past N zero."""
    w = np.random.default_rng(K + N).integers(-128, 128, (K, N), dtype=np.int8)
    geo = te.mma_geometry(1, K, N)
    mt = geo["mt"]
    for chunk in range(geo["chunks"]):
        n0 = chunk * 16 * mt
        rows = np.zeros((16 * mt, K), np.int8)
        rows[:max(0, min(N - n0, 16 * mt))] = w[:, n0:n0 + 16 * mt].T
        got = te.mma_fragment_build(w, n0, mt)
        assert np.array_equal(got.reshape(-1), tflat.mma_fragments(rows))


def _covers_every_item_once(M, K, N):
    geo = te.mma_geometry(M, K, N)
    assert geo["smem"] <= te.MAX_FRAG_BYTES + 16 * 16 * te.MAX_MTILES
    assert geo["by"] * geo["chunks"] <= te.MAX_BLOCKS
    assert geo["chunks"] * 16 * geo["mt"] >= N > (geo["chunks"] - 1) * 16 * geo["mt"]
    seen = np.zeros(geo["items"], np.int64)
    for blk in range(geo["by"]):
        first = blk * geo["ipb"]
        for warp in range(te.MMA_WARPS):
            np.add.at(seen, np.arange(first + warp, min(first + geo["ipb"], geo["items"]),
                                      te.MMA_WARPS), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("M,K,N", sorted(set(PD_SHAPES)))
def test_geometry_covers_every_item_once(M, K, N):
    _covers_every_item_once(M, K, N)


@pytest.mark.parametrize("K", [64, 65, 100, 130, 256, 4000])
def test_geometry_covers_every_item_once_at_edges(K):
    for M in (1, 5, 513, 70000):
        for N in (2, 4, 11, 16, 129, 250, 256):
            _covers_every_item_once(M, K, N)


def test_path_rule_on_person_detect():
    """The rule on the 14 shapes person_detect gives ``qgemm`` (captured from
    a forward through ``backend="pallas"``, scaled to batch 8192): the
    tensor cores from K = 64 up, the narrow path (``qgemm_rows``) below,
    where it beat the tensor cores at all four shapes (K = 8, 16, 32, 32)
    on the same card in the same call (PERF.md)."""
    shapes = []
    orig = tqgemm.qgemm

    def spy(x, w, *args, **kw):
        shapes.append((x.shape[0] * 8192, x.shape[1], w.shape[1]))
        return orig(x, w, *args, **kw)

    m = compile_tflite(model_path("person_detect"), backend="pallas", device="cpu")
    import microflow_tpu_torch.kernels as kernels

    kernels.qgemm = spy
    try:
        m.predict_inner(torch.zeros((1, 96, 96, 1), dtype=torch.int8))
    finally:
        kernels.qgemm = orig
    assert shapes == PD_SHAPES
    assert [tqgemm.qgemm_path(*s) for s in shapes] == ["dp4a"] * 4 + ["mma"] * 10


@pytest.mark.parametrize("K,path", [(1, "dp4a"), (8, "dp4a"), (16, "dp4a"), (32, "dp4a"),
                                    (37, "dp4a"), (63, "dp4a"), (64, "mma"), (65, "mma"),
                                    (130, "mma"), (4000, "mma"), (4096, "mma"), (4097, "dp4a"),
                                    (20000, "dp4a")])
def test_path_rule_on_edges(K, path):
    """K alone decides: the narrow path below 64 (sine's K = 1 and 16 and
    person_detect's 8, 16 and 32 among them), the tensor cores to
    ``MMA_MAX_K``, the shared-memory tiles past it."""
    for M, N in ((1, 2), (70000, 256)):
        assert tqgemm.qgemm_path(M, K, N) == path


def test_path_rule_bound_is_the_kernels():
    """The entry point refuses ``"mma"`` past ``kMmaMaxK``; the rule stops there."""
    assert tqgemm.MMA_MAX_K == te.qgemm_constant("kMmaMaxK")
    assert tqgemm.MMA_MAX_K * 16 == te.MAX_FRAG_BYTES  # one m-tile's units fill the stage


@pytest.mark.parametrize("K,path", [(8, "wmma"), (4097, "mma")])
def test_wrapper_refuses_a_path_it_has_not(K, path):
    args = torch_args(*_case(3, K, 4))
    with pytest.raises(ValueError):
        tqgemm.qgemm(*args, activation=TAct.NONE, out_scale=1.0, out_zp=0, path=path)
