"""The port's kernel modules against the JAX package's Pallas kernels.

Here, on the CPU, the plain versions (``qgemm_reference``,
``qdwconv_reference``) are held against the JAX kernels run in Pallas
interpret mode, at the shapes of ``tests/test_pallas_parity.py`` plus a
10x8/s2 depthwise case, under the FMA rule of ``torch_parity.py``.  The
CUDA kernels themselves are tested on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from microflow_tpu.core import FusedActivation as JAct
from microflow_tpu.kernels import qdwconv as j_qdwconv
from microflow_tpu.kernels import qgemm as j_qgemm
from microflow_tpu_torch.core import FusedActivation as TAct
from microflow_tpu_torch.kernels import (
    LAUNCHES,
    qdwconv,
    qdwconv_reference,
    qgemm,
    qgemm_reference,
)
from test_torch_cuda import dw_case, gemm_case, np_zp_padded, torch_args

F32 = np.float32


@pytest.mark.parametrize("M,K,N,w_zp,act", [
    (5, 37, 11, 3, "relu6"),                     # test_pallas_parity.py shape
    (33, 1, 16, 0, "relu"),                      # sine's first layer: K = 1
    (17, 64, 130, np.arange(130) % 7 - 3, "none"),  # per-column w_zp, N > 128
])
def test_qgemm_reference_matches_pallas(M, K, N, w_zp, act):
    rng = np.random.default_rng(7)
    x, w, wzp, d, bias0, c1 = gemm_case(rng, M, K, N, w_zp, in_zp=-7)
    kw = dict(out_scale=0.05, out_zp=4)
    ref = np.asarray(j_qgemm(*(jnp.asarray(a) for a in (x, w, wzp, d, bias0, c1)),
                             activation=JAct(act), **kw))
    got = qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), activation=TAct(act), **kw)
    q = (x.astype(np.int64) @ w.astype(np.int64)
         - x.astype(np.int64).sum(1, keepdims=True) * wzp + d)
    lo, hi = tp.bounds(JAct(act), 0.05, 4, np.int8)
    tp.assert_fma_rule(got.numpy(), ref, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


def test_qgemm_reference_on_fma_sensitive_epilogues():
    """X = 0 makes q = d[n]: each column carries one (q, bias0, c1) triple
    on which a fused multiply-add would round differently."""
    rng = np.random.default_rng(8)
    q, bias0, c1 = tp.fma_sensitive(rng, 24)
    n = len(q)
    x = np.zeros((3, 4), np.int8)
    w = rng.integers(-128, 128, (4, n), dtype=np.int8)
    wzp, d = np.zeros(n, np.int32), q.astype(np.int32)
    kw = dict(out_scale=1.0, out_zp=0)
    ref = np.asarray(j_qgemm(*(jnp.asarray(a) for a in (x, w, wzp, d, bias0, c1)),
                             activation=JAct.NONE, **kw))
    got = qgemm_reference(*torch_args(x, w, wzp, d, bias0, c1), activation=TAct.NONE, **kw)
    sep, fma = tp.epilogue_pair(c1, np.broadcast_to(q.astype(F32), (3, n)), bias0, -128, 127)
    assert tp.assert_fma_rule(got.numpy(), ref, sep, fma) > 0


@pytest.mark.parametrize("B,H,W,C,kh,kw,sr,sc", [
    (3, 9, 9, 4, 3, 3, 1, 1),    # test_pallas_parity.py shapes
    (3, 9, 9, 4, 3, 3, 2, 2),
    (2, 21, 18, 8, 10, 8, 2, 2),  # speech's 10x8/s2 stem, cut to size
])
def test_qdwconv_reference_matches_pallas(B, H, W, C, kh, kw, sr, sc):
    rng = np.random.default_rng(11)
    x, wc, d, bias0, c1, geo = dw_case(rng, B, H, W, C, kh, kw, sr, sc, in_zp=-2)
    xp = np_zp_padded(x, C, geo)
    kwargs = dict(out_scale=0.07, out_zp=-1, **geo)
    jkw = {k: v for k, v in kwargs.items() if k not in ("in_zp", "pad_top", "pad_left")}
    ref = np.asarray(j_qdwconv(*(jnp.asarray(a) for a in (xp, wc, d, bias0, c1)),
                               activation=JAct.RELU, **jkw))
    got = qdwconv_reference(*torch_args(x, wc, d, bias0, c1), activation=TAct.RELU, **kwargs)
    q = np.zeros(ref.shape, np.int64)
    for m in range(kh):
        for n in range(kw):
            q += xp[:, m::sr, n::sc, :][:, :geo["oh"], :geo["ow"], :].astype(np.int64) * wc[m, n]
    q += d
    lo, hi = tp.bounds(JAct.RELU, 0.07, -1, np.int8)
    tp.assert_fma_rule(got.numpy(), ref, *tp.epilogue_pair(c1, q.astype(F32), bias0, lo, hi))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(1)
    args = torch_args(*gemm_case(rng, 9, 13, 5, 2, in_zp=3))
    before = LAUNCHES.copy()
    kw = dict(activation=TAct.RELU6, out_scale=0.03, out_zp=-5)
    assert torch.equal(qgemm(*args, **kw), qgemm_reference(*args, **kw))
    x, wc, d, bias0, c1, geo = dw_case(rng, 2, 7, 7, 6, 3, 3, 2, 2, in_zp=1)
    dargs = torch_args(x, wc, d, bias0, c1)
    assert torch.equal(qdwconv(*dargs, **kw, **geo), qdwconv_reference(*dargs, **kw, **geo))
    assert LAUNCHES == before


def test_other_devices_raise():
    x = torch.empty((4, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qgemm(x, x, x, x, x, x, activation=TAct.NONE, out_scale=1.0, out_zp=0)
