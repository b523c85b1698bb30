// Segment megakernel for Hopper (sm_90a): backends "fused" and "hybrid".
//
// Replaces the Pallas kernel microflow_tpu/kernels/megakernel.py::_segment_call
// (reached through build_fused_forward): one segment of consecutive
// depthwise conv, Conv2D, FullyConnected, AveragePool and int8 Quantize
// layers in one launch, int8 [B, in_elems] -> int8 [B, out_elems].  The plan
// (op descriptors in the flat kernel's layout, then each op's constants) is
// one device buffer made once per model by kernels/megakernel.py::pack_segment.
//
// What bounds it on an H100: operations.  person_detect's fused segment
// (layers 0-28) does 7.16M multiply-adds per sample on 9,216 input bytes and
// 2 output bytes, so at batch 8192 the int8 tensor-core peak allows
// 0.059 ms and HBM 0.023 ms.  The design keeps every intermediate tensor on
// chip, in the persistent block loop that csrc/flatpack.cu uses
// (segment_ops.cuh: run_plan; 36,864 + 18,432 bytes of shared memory for
// person_detect, four blocks an SM).  Where the TPU kernel swept stride-1
// windows and decimated, each thread here computes its strided output
// directly.
//
// The ops of the largest classes take the flat kernel's paths
// (segment_ops.cuh), as the plan marks them: the 1x1 convs with a multiple
// of 16 output channels and no weight zero point on the int8 tensor cores
// (F_MMA: op_pw_mma; person_detect's 13 wide ones), the 3x3 depthwise
// convs at stride 1 or 2 and the 3x3/s2 stem from one channel in strips
// (F_DW3: op_dw3, op_dw3_stem; all 14 of person_detect's), and other
// depthwise convs over a multiple of 4 channels four channels a thread
// (F_VEC: op_dw_vec; speech's 10x8 stem), each where its centred taps
// w - w_zp fit int8.  The rest is this file's: a depthwise conv one output
// a thread with int32 taps, any Conv2D, a 1x1 conv over a multiple of 4
// channels by __dp4a with a weight zero point, FullyConnected and Quantize.
//
// Every weight may carry a zero point (per channel for the convs), so the
// accumulator is sum over in-bounds taps (x - in_zp) * (w - w_zp), exact in
// int32; a tap outside the input is skipped, or reads in_zp (the shared
// paths), which equals the reference's zero-point padding.  Every requant
// is round-half-away (roundf), as the JAX kernel's lax.round(...,
// AWAY_FROM_ZERO), on y = bias0 + c1 * f32(q) with the multiply and the add
// rounded apart (csrc/epilogue.cuh, -fmad=false); the plan sets F_EXACT on
// every op, so the shared paths round so too.

#include "segment_ops.cuh"

namespace {

enum { K_DW, K_CONV, K_PW, K_FC, K_POOL, K_QUANTIZE };

__device__ __forceinline__ int8_t requant_away(int acc, float b0, float c1, float lo, float hi) {
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
    dst[e] = requant_away(acc, __ldg(b0 + c), __ldg(c1 + c), lo, hi);
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
    dst[e] = requant_away(acc, __ldg(b0 + f), __ldg(c1 + f), lo, hi);
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
    dst[e] = requant_away(q, __ldg(b0 + f), __ldg(c1 + f), lo, hi);
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
    if (lane == 0)
      dst[n] = requant_away(acc + __ldg(off + n), __ldg(b0 + n), __ldg(c1 + n), lo, hi);
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

__global__ void __launch_bounds__(kThreads, 4)
    segment_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long B,
                   const unsigned char* __restrict__ plan, int n_ops, int in_elems,
                   int out_elems, int smem_a) {
  run_plan(x, out, B, plan, n_ops, in_elems, out_elems, smem_a,
           [](const Op& op, const int8_t* src, int8_t* dst) {
             switch (op[F_KIND]) {
               case K_DW:
                 switch (op[F_DW3]) {
                   case DW3_S1: op_dw3<1>(op, src, dst); break;
                   case DW3_S2: op_dw3<2>(op, src, dst); break;
                   case DW3_STEM: op_dw3_stem(op, src, dst); break;
                   default:
                     if (op[F_VEC]) op_dw_vec(op, src, dst);
                     else op_dw(op, src, dst);
                 }
                 break;
               case K_CONV: op_conv(op, src, dst); break;
               case K_PW:
                 if (op[F_MMA]) op_pw_mma(op, src, dst);
                 else op_pw(op, src, dst);
                 break;
               case K_FC: op_fc(op, src, dst); break;
               case K_POOL: op_pool(op, src, dst); break;
               default: op_quantize(op, src, dst); break;
             }
           });
}

// What the kernel's reads assume of a plan, checked on the host copy of
// its descriptors: every op reads and writes inside its shared-memory
// buffer (16-byte multiples) and takes the tensor the op before it wrote;
// a 1x1 conv reads whole words of pixels inside its input; the shared
// paths' own assumptions hold (segment_ops.cuh: shared_path_ok).
bool plan_ok(const int* desc, const void* plan, int n_ops, int in_elems, int out_elems,
             int smem_a, int smem_b) {
  if (smem_a % 16 || smem_b % 16 || reinterpret_cast<uintptr_t>(plan) % 16 || in_elems > smem_b)
    return false;
  long long cur = in_elems;
  for (int o = 0; o < n_ops; ++o) {
    const int* f = desc + o * NF;
    const int kind = f[F_KIND], c = f[F_OC], ic = f[F_IC];
    const long long n_in = f[F_IN], n_out = f[F_OUT];
    if (kind < K_DW || kind > K_QUANTIZE || n_in != cur || n_out <= 0 ||
        n_out > ((o & 1) ? smem_b : smem_a))
      return false;
    cur = n_out;
    if (kind == K_FC) continue;
    if (kind == K_QUANTIZE) {
      if (n_out != n_in) return false;
      continue;
    }
    if ((long long)f[F_IH] * f[F_IW] * ic != n_in || (long long)f[F_OH] * f[F_OW] * c != n_out)
      return false;
    if (kind == K_POOL && c != ic) return false;
    if (kind == K_PW && (ic % 4 || (f[F_OH] - 1) * f[F_SR] >= f[F_IH] ||
                         (f[F_OW] - 1) * f[F_SC] >= f[F_IW]))
      return false;
    if (!shared_path_ok(f, K_DW, K_PW)) return false;
  }
  return cur == out_elems;
}

}  // namespace

// Plain C entry point (bound with ctypes).  plan: the device buffer of
// kernels/megakernel.py::pack_segment; desc: a host copy of its first
// n_ops descriptors, which the entry point checks (plan_ok) and refuses the
// launch with cudaErrorInvalidValue if a read would not hold;
// smem_a/smem_b: its two buffer sizes.  Returns the CUDA error code (0 on
// success); a launch the card refuses returns its error here.
extern "C" int mf_megakernel(const void* x, void* out, long long B, const void* plan,
                             const int* desc, int n_ops, int in_elems, int out_elems, int smem_a,
                             int smem_b, void* stream) {
  if (B <= 0 || n_ops <= 0 || in_elems <= 0 || out_elems <= 0 ||
      !plan_ok(desc, plan, n_ops, in_elems, out_elems, smem_a, smem_b))
    return (int)cudaErrorInvalidValue;
  return launch_plan(segment_kernel, x, out, B, plan, n_ops, in_elems, out_elems, smem_a, smem_b,
                     stream);
}
