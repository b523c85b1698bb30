// Packed-pipeline kernel for Hopper (sm_90a): backend "packed".
//
// Replaces the Pallas kernel microflow_tpu/kernels/packed.py::build_packed_kernel
// (body `kernel`, launcher `packed_fn`): the depthwise/pointwise prefix of a
// MobileNet-style graph in one launch, int8 [B, H, W] -> int8
// [B, h_out, w_out * c_out].  The plan (op descriptors, then each op's
// weights and per-lane d / bias0 / c1 planes) is one device buffer made once
// per model by kernels/packed.py::pack_packed.
//
// What bounds it on an H100: operations.  person_detect's prefix (layers
// 0-22) does 6.24M multiply-adds per sample on 9,216 input bytes and 4,608
// output bytes, so at batch 8192 the int8 tensor-core peak allows 0.052 ms
// and HBM 0.034 ms.  The design keeps the TPU kernel's layout idea, which
// maps well to the card: one block a sample holds the activation as H + 2
// rows of W*C int8 lanes in shared memory (two ping-pong buffers, each sized
// to the largest tensor of its parity), and the two guard rows hold the
// zero point, so the three vertical taps of a 3x3 window read a guard row
// where the reference pads and need no bounds test.  A horizontal tap
// outside the row is skipped: its constant w * in_zp is already in the
// plan's d plane (the JAX plan's edge_d), so it is counted once.  Each op
// rewrites its output's guard rows to its output zero point.  Where the
// TPU kernel swept a stride-2 layer at every column and decimated later,
// each thread here computes its strided output directly and reads the
// planes at the swept column it stands for (plane lane = pcs * j * C + c).
// This first version is simple: one output a thread, scalar int32
// multiply-adds for the 3x3 taps, __dp4a for the 1x1 convs over a multiple
// of 4 channels.  No tensor cores.
//
// Requant: y = bias0[lane] + c1[lane] * f32(acc + d[lane]) with the multiply
// and the add rounded apart, then roundf and the clip (csrc/epilogue.cuh,
// -fmad=false), as the JAX kernel's lax.round(..., AWAY_FROM_ZERO).

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int NF = 20;  // int32 fields per op descriptor (kernels/packed.py)
enum {
  F_KIND, F_IH, F_IW, F_IC, F_OH, F_OW, F_OC, F_SR, F_SC, F_PCS, F_OUTZP, F_LO, F_HI, F_W, F_D,
  F_BIAS, F_C1
};
enum { K_DW, K_PW };

struct Op {
  const int* f;
  const unsigned char* plan;
  __device__ int operator[](int i) const { return __ldg(f + i); }
  template <typename T>
  __device__ const T* at(int field) const {
    return reinterpret_cast<const T*>(plan + __ldg(f + field));
  }
};

// The stem (IC == 1: every output channel reads the single input channel)
// and the 3x3 depthwise convs.  Weights int8 [9][OC].  src has IH + 2 rows
// of IW * IC lanes; output row i reads rows sr*i .. sr*i + 2 (guards
// included), output column j reads columns sc*j - 1 .. sc*j + 1.
__device__ void op_dw(const Op& op, const int8_t* src, int8_t* dst) {
  const int iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int sr = op[F_SR], sc = op[F_SC], pcs = op[F_PCS];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);
  const int* d = op.at<int>(F_D);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const int row_in = iw * ic, row_out = ow * oc, total = oh * row_out;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int c = e % oc, p = e / oc;
    const int i = p / ow, j = p % ow;
    const int ci = ic == 1 ? 0 : c;
    int acc = 0;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int8_t* row = src + (sr * i + dh) * row_in;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int q = sc * j + dw - 1;
        if (q < 0 || q >= iw) continue;
        acc += (int)row[q * ic + ci] * (int)__ldg(w + (dh * 3 + dw) * oc + c);
      }
    }
    const int lane = pcs * j * oc + c;
    dst[(i + 1) * row_out + j * oc + c] =
        mf_round_away(mf_affine(__ldg(b0 + lane), __ldg(c1 + lane), acc + __ldg(d + lane)), lo,
                      hi);
  }
}

// 1x1 conv: out (i, j, f) = sum_ci x[i, j, ci] * w[f, ci] + d[lane].
// When IC % 4 == 0, __dp4a on [IC/4][OC] words (word (k, f) packs input
// channels 4k..4k+3 of filter f); else int8 [IC][OC].  Either way
// neighbouring threads (neighbouring f) read neighbouring weights.
__device__ void op_pw(const Op& op, const int8_t* src, int8_t* dst) {
  const int iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);
  const int* d = op.at<int>(F_D);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const int row_out = ow * oc, total = oh * row_out;
  const bool vec = (ic & 3) == 0;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int f = e % oc, p = e / oc;
    const int i = p / ow, j = p % ow;
    const int8_t* xs = src + (i + 1) * iw * ic + j * ic;
    int acc = 0;
    if (vec) {
      const int* xw = reinterpret_cast<const int*>(xs);
      const int* w4 = reinterpret_cast<const int*>(w) + f;
      for (int k = 0; k < (ic >> 2); ++k) acc = __dp4a(xw[k], __ldg(w4 + k * oc), acc);
    } else {
      for (int k = 0; k < ic; ++k) acc += (int)xs[k] * (int)__ldg(w + k * oc + f);
    }
    const int lane = j * oc + f;
    dst[(i + 1) * row_out + lane] =
        mf_round_away(mf_affine(__ldg(b0 + lane), __ldg(c1 + lane), acc + __ldg(d + lane)), lo,
                      hi);
  }
}

// Both guard rows of an output tensor of `rows` data rows hold `zp`.
__device__ void write_guards(int8_t* buf, int rows, int lanes, int zp) {
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    buf[l] = (int8_t)zp;
    buf[(rows + 1) * lanes + l] = (int8_t)zp;
  }
}

__global__ void __launch_bounds__(kThreads)
    packed_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                  const unsigned char* __restrict__ plan, int n_ops, int in_zp, int smem_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf_a = reinterpret_cast<int8_t*>(smem);
  int8_t* buf_b = reinterpret_cast<int8_t*>(smem + smem_a);
  const int* desc = reinterpret_cast<const int*>(plan);
  const long long b = blockIdx.x;
  // the input: H rows of W lanes between two guard rows of in_zp
  const Op first{desc, plan};
  const int h = first[F_IH], w = first[F_IW];
  const int8_t* xr = x + b * h * w;
  for (int i = threadIdx.x; i < h * w; i += kThreads) buf_b[w + i] = __ldg(xr + i);
  write_guards(buf_b, h, w, in_zp);
  __syncthreads();
  const int8_t* src = buf_b;
  for (int o = 0; o < n_ops; ++o) {
    const Op op{desc + o * NF, plan};
    int8_t* dst = (o & 1) ? buf_b : buf_a;
    if (op[F_KIND] == K_DW) op_dw(op, src, dst);
    else op_pw(op, src, dst);
    write_guards(dst, op[F_OH], op[F_OW] * op[F_OC], op[F_OUTZP]);
    __syncthreads();
    src = dst;
  }
  const Op last{desc + (n_ops - 1) * NF, plan};
  const int lanes = last[F_OH] * last[F_OW] * last[F_OC];
  const int8_t* data = src + last[F_OW] * last[F_OC];  // past the top guard row
  int8_t* orow = out + b * lanes;
  for (int i = threadIdx.x; i < lanes; i += kThreads) orow[i] = data[i];
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: int8 [B, H, W]; plan: the
// device buffer of kernels/packed.py::pack_packed; in_zp: the stem's input
// zero point (the input's guard rows); smem_a/smem_b: the two buffer sizes.
// One block a sample.  Returns the CUDA error code (0 on success).
extern "C" int mf_packed(const void* x, void* out, long long B, const void* plan, int n_ops,
                         int in_zp, int smem_a, int smem_b, void* stream) {
  if (B <= 0 || n_ops <= 0 || B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = smem_a + smem_b;
  cudaError_t err =
      cudaFuncSetAttribute(packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  packed_kernel<<<(unsigned)B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out),
      static_cast<const unsigned char*>(plan), n_ops, in_zp, smem_a);
  return (int)cudaGetLastError();
}
