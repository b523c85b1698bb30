// Segment megakernel for Hopper (sm_90a): backends "fused" and "hybrid".
//
// Replaces the Pallas kernel microflow_tpu/kernels/megakernel.py::_segment_call
// (reached through build_fused_forward): one segment of consecutive
// depthwise conv, Conv2D, FullyConnected, AveragePool and int8 Quantize
// layers in one launch, int8 [B, in_elems] -> int8 [B, out_elems].  The plan
// (op descriptors, then each op's constants) is one device buffer made once
// per model by kernels/megakernel.py::pack_segment.
//
// What bounds it on an H100: operations.  person_detect's fused segment
// (layers 0-28) does 7.16M multiply-adds per sample on 9,216 input bytes and
// 2 output bytes, so at batch 8192 the int8 tensor-core peak allows
// 0.059 ms and HBM 0.023 ms.  The design keeps every intermediate tensor on
// chip, as csrc/flatpack.cu does: a persistent block takes one sample at a
// time, stages its input row in shared memory and runs op after op between
// two ping-pong shared-memory buffers (each sized to the largest tensor of
// its parity; 36,864 + 18,432 bytes for person_detect), with
// __syncthreads() between ops.  Where the TPU kernel swept stride-1 windows
// and decimated, each thread here computes its strided output directly.
// This first version is simple: scalar int32 multiply-adds, one output a
// thread, except the 1x1 convs over a multiple of 4 channels (86% of
// person_detect's multiply-adds), which take __dp4a.  No tensor cores.
//
// Every weight may carry a zero point (per channel for the convs), so the
// accumulator is sum over in-bounds taps (x - in_zp) * (w - w_zp), exact in
// int32; a tap outside the input is skipped, which equals the reference's
// zero-point padding.  Every requant is round-half-away (roundf), as the JAX
// kernel's lax.round(..., AWAY_FROM_ZERO), on y = bias0 + c1 * f32(q) with
// the multiply and the add rounded apart (csrc/epilogue.cuh, -fmad=false).

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int NF = 32;  // int32 fields per op descriptor (kernels/megakernel.py)
enum {
  F_KIND, F_IH, F_IW, F_IC, F_OH, F_OW, F_OC, F_KH, F_KW, F_SR, F_SC, F_PT, F_PL, F_ZP, F_LO,
  F_HI, F_W, F_WZP, F_D, F_BIAS, F_C1, F_RECIP, F_S0, F_S1, F_OUTZP, F_IN, F_OUT
};
enum { K_DW, K_CONV, K_PW, K_FC, K_POOL, K_QUANTIZE };

struct Op {
  const int* f;
  const unsigned char* plan;
  __device__ int operator[](int i) const { return __ldg(f + i); }
  template <typename T>
  __device__ const T* at(int field) const {
    return reinterpret_cast<const T*>(plan + __ldg(f + field));
  }
};

__device__ __forceinline__ int8_t requant(int acc, float b0, float c1, float lo, float hi) {
  return mf_round_away(mf_affine(b0, c1, acc), lo, hi);
}

// Depthwise conv, one output a thread.  Output channel c reads input
// channel c, or channel 0 when c is past the input's channels (the
// reference's depth-multiplier fallback, the JAX package's channel gather).
// Weights: int32 [KH*KW][OC], already w - w_zp[c].
__device__ void op_dw(const Op& op, const int8_t* src, int8_t* dst) {
  const int ih = op[F_IH], iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int kh = op[F_KH], kw = op[F_KW], sr = op[F_SR], sc = op[F_SC];
  const int pt = op[F_PT], pl = op[F_PL], zp = op[F_ZP];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int* w = op.at<int>(F_W);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const int total = oh * ow * oc;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int c = e % oc, p = e / oc;
    const int r0 = (p / ow) * sr - pt, q0 = (p % ow) * sc - pl;
    const int ci = c < ic ? c : 0;
    int acc = 0;
    for (int dh = 0; dh < kh; ++dh) {
      const int r = r0 + dh;
      if (r < 0 || r >= ih) continue;
      for (int dw = 0; dw < kw; ++dw) {
        const int q = q0 + dw;
        if (q < 0 || q >= iw) continue;
        acc += ((int)src[(r * iw + q) * ic + ci] - zp) * __ldg(w + (dh * kw + dw) * oc + c);
      }
    }
    dst[e] = requant(acc, __ldg(b0 + c), __ldg(c1 + c), lo, hi);
  }
}

// Any Conv2D, one output a thread: filters int8 [OC][KH][KW][IC], zero
// points int32 [OC].
__device__ void op_conv(const Op& op, const int8_t* src, int8_t* dst) {
  const int ih = op[F_IH], iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int kh = op[F_KH], kw = op[F_KW], sr = op[F_SR], sc = op[F_SC];
  const int pt = op[F_PT], pl = op[F_PL], zp = op[F_ZP];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);
  const int* wzp = op.at<int>(F_WZP);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const int total = oh * ow * oc;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int f = e % oc, p = e / oc;
    const int r0 = (p / ow) * sr - pt, q0 = (p % ow) * sc - pl;
    const int wz = __ldg(wzp + f);
    int acc = 0;
    for (int dh = 0; dh < kh; ++dh) {
      const int r = r0 + dh;
      if (r < 0 || r >= ih) continue;
      for (int dw = 0; dw < kw; ++dw) {
        const int q = q0 + dw;
        if (q < 0 || q >= iw) continue;
        const int8_t* xs = src + (r * iw + q) * ic;
        const int8_t* ws = w + ((f * kh + dh) * kw + dw) * ic;
        for (int ci = 0; ci < ic; ++ci) acc += ((int)xs[ci] - zp) * ((int)__ldg(ws + ci) - wz);
      }
    }
    dst[e] = requant(acc, __ldg(b0 + f), __ldg(c1 + f), lo, hi);
  }
}

// 1x1 conv (any stride) over IC % 4 == 0 channels, one output a thread: the
// raw int8 dot and the pixel's channel sum by __dp4a, then
// q = dot - w_zp[f] * sum + d[f], with d[f] = IC*in_zp*w_zp[f] - in_zp*colsum[f]
// (every tap of a 1x1 window is in bounds).  Weights: [IC/4][OC] words.
__device__ void op_pw(const Op& op, const int8_t* src, int8_t* dst) {
  const int iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int sr = op[F_SR], sc = op[F_SC];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int* w4 = op.at<int>(F_W);
  const int* wzp = op.at<int>(F_WZP);
  const int* d = op.at<int>(F_D);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const int k4 = ic >> 2, total = oh * ow * oc;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int f = e % oc, p = e / oc;
    const int ip = (p / ow) * sr * iw + (p % ow) * sc;
    const int* xw = reinterpret_cast<const int*>(src + ip * ic);
    int dot = 0, sum = 0;
    for (int k = 0; k < k4; ++k) {
      const int xv = xw[k];
      dot = __dp4a(xv, __ldg(w4 + k * oc + f), dot);
      sum = __dp4a(xv, 0x01010101, sum);
    }
    const int q = dot - __ldg(wzp + f) * sum + __ldg(d + f);
    dst[e] = requant(q, __ldg(b0 + f), __ldg(c1 + f), lo, hi);
  }
}

// FullyConnected: one warp an output, lanes over K, then a shuffle sum
// (integer, so the order does not matter): q = sum x*(w - w_zp) + (c3 - c2[n]).
// Weights are [N][K].
__device__ void op_fc(const Op& op, const int8_t* src, int8_t* dst) {
  const int K = op[F_IN], N = op[F_OUT], wz = op[F_S0];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);
  const int* off = op.at<int>(F_D);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const int lane = threadIdx.x & 31;
  for (int n = threadIdx.x >> 5; n < N; n += kThreads / 32) {
    const int8_t* wr = w + (size_t)n * K;
    int acc = 0;
    for (int k = lane; k < K; k += 32) acc += (int)src[k] * ((int)__ldg(wr + k) - wz);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) dst[n] = requant(acc + __ldg(off + n), __ldg(b0 + n), __ldg(c1 + n), lo, hi);
  }
}

// AveragePool: in-bounds sum (true zeros outside), then
// roundf(c0 * (recip[p] * f32(sum)) + c1), clamped.
__device__ void op_pool(const Op& op, const int8_t* src, int8_t* dst) {
  const int ih = op[F_IH], iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW];
  const int kh = op[F_KH], kw = op[F_KW], sr = op[F_SR], sc = op[F_SC];
  const int pt = op[F_PT], pl = op[F_PL];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const float c0 = __int_as_float(op[F_S0]), c1 = __int_as_float(op[F_S1]);
  const float* recip = op.at<float>(F_RECIP);
  const int total = oh * ow * ic;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int ch = e % ic, p = e / ic;
    const int r0 = (p / ow) * sr - pt, q0 = (p % ow) * sc - pl;
    int s = 0;
    for (int dh = 0; dh < kh; ++dh) {
      const int r = r0 + dh;
      if (r < 0 || r >= ih) continue;
      for (int dw = 0; dw < kw; ++dw) {
        const int q = q0 + dw;
        if (q >= 0 && q < iw) s += src[(r * iw + q) * ic + ch];
      }
    }
    const float t = __fmul_rn(__ldg(recip + p), __int2float_rn(s));
    dst[e] = mf_round_away(__fadd_rn(__fmul_rn(c0, t), c1), lo, hi);
  }
}

// Quantize int8 -> int8: roundf(in_s * (f32(x) - f32(in_zp)) / out_s + out_zp)
// with an IEEE division (never a reciprocal multiply), saturated to int8.
__device__ void op_quantize(const Op& op, const int8_t* src, int8_t* dst) {
  const int n = op[F_IN];
  const float in_s = __int_as_float(op[F_S0]), out_s = __int_as_float(op[F_S1]);
  const float in_zp = (float)op[F_ZP], out_zp = (float)op[F_OUTZP];
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float deq = __fmul_rn(in_s, __fsub_rn((float)src[e], in_zp));
    dst[e] = mf_round_away(__fadd_rn(__fdiv_rn(deq, out_s), out_zp), -128.0f, 127.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
    segment_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long B,
                   const unsigned char* __restrict__ plan, int n_ops, int in_elems,
                   int out_elems, int smem_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf_a = reinterpret_cast<int8_t*>(smem);
  int8_t* buf_b = reinterpret_cast<int8_t*>(smem + smem_a);
  const int* desc = reinterpret_cast<const int*>(plan);
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const int8_t* xr = x + b * in_elems;
    for (int i = threadIdx.x; i < in_elems; i += kThreads) buf_b[i] = __ldg(xr + i);
    __syncthreads();
    const int8_t* src = buf_b;
    for (int o = 0; o < n_ops; ++o) {
      const Op op{desc + o * NF, plan};
      int8_t* dst = (o & 1) ? buf_b : buf_a;
      switch (op[F_KIND]) {
        case K_DW: op_dw(op, src, dst); break;
        case K_CONV: op_conv(op, src, dst); break;
        case K_PW: op_pw(op, src, dst); break;
        case K_FC: op_fc(op, src, dst); break;
        case K_POOL: op_pool(op, src, dst); break;
        default: op_quantize(op, src, dst); break;
      }
      __syncthreads();
      src = dst;
    }
    int8_t* orow = out + b * out_elems;
    for (int i = threadIdx.x; i < out_elems; i += kThreads) orow[i] = src[i];
    __syncthreads();  // the next sample's input overwrites buffer B
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  plan: the device buffer of
// kernels/megakernel.py::pack_segment; smem_a/smem_b: its two buffer sizes.
// Returns the CUDA error code (0 on success); a launch the card refuses
// returns its error here.
extern "C" int mf_megakernel(const void* x, void* out, long long B, const void* plan, int n_ops,
                             int in_elems, int out_elems, int smem_a, int smem_b, void* stream) {
  if (B <= 0 || n_ops <= 0 || in_elems <= 0 || out_elems <= 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_a + smem_b;
  cudaError_t err =
      cudaFuncSetAttribute(segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = B < (long long)per_sm * sms ? B : (long long)per_sm * sms;
  segment_kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), B,
      static_cast<const unsigned char*>(plan), n_ops, in_elems, out_elems, smem_a);
  return (int)cudaGetLastError();
}
