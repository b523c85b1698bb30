// Whole-network flat kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel microflow_tpu/kernels/flatpack.py::build_flat_kernel
// (body `kernel`, launcher `flat_fn`): the whole flat-packable prefix of a
// graph -- depthwise and pointwise convs, any Conv2D, FullyConnected,
// AveragePool, Softmax -- in one launch, int8 [B, in_elems] -> int8
// [B, out_elems].  The plan (op descriptors, then each op's constants) is one
// device buffer made once per model by kernels/flatpack.py::pack_plan.
//
// What bounds it on an H100: operations.  person_detect does 7.16M
// multiply-adds per sample on 9,216 input bytes and 2 output bytes, so at
// batch 8192 the int8 tensor-core peak allows 0.059 ms and HBM 0.023 ms.
// The design keeps every intermediate tensor on chip, in the persistent
// block loop of segment_ops.cuh (run_plan): person_detect's plan is 244 KB
// and stays in L2.
//
// The 1x1 convs do 86% of the multiply-adds.  Those with a multiple of 16
// output channels (all of person_detect's but the 2-channel head) run on
// the int8 tensor cores (op_pw_mma), so a block loads 414 KB of weights a
// sample for person_detect's 1x1 convs, not one byte per multiply-add (6.2
// MB) as the __dp4a path does, whose L2 traffic bounded them before
// (scripts/torch_flat_layers.py prints both per op).  The 3x3 depthwise
// convs (all 14 of person_detect's) do 13.5% of the multiply-adds but make
// 107,136 outputs a sample; they take the strips of op_dw3 and op_dw3_stem.
// Both paths, op_dw_vec and the pool are in segment_ops.cuh, shared with
// csrc/megakernel.cu and csrc/packed.cu.  The other 1x1 convs over a
// multiple of 4 channels use __dp4a, four output channels a thread, one
// pixel at a time; the other depthwise convs and any Conv2D are scalar
// integer work on the CUDA cores (general_ops.cuh, shared with
// csrc/packed.cu); FullyConnected and the softmax are this file's.
//
// Every read stays in bounds: a tap outside the input is skipped, or reads
// in_zp in place of the input (either way it adds (in_zp - in_zp) * w = 0,
// as in the reference), where the TPU kernel read past the row into its
// tile padding.  Epilogues: csrc/epilogue.cuh.  flat_kernel<kMode> is one
// instantiation a requant mode of the TPU kernel (segment_ops.cuh):
// <R_EXACT2> runs "exact2" and "exact" (F_EXACT says which); <R_FIXED> is
// "fixed", the integer (M, S) epilogue on every op path (its plan: bias_q and
// m in the F_BIAS and F_C1 words); <R_RAW> and <R_NOROUND> are the
// measurement-only "raw" (the accumulator's low byte; its plan packs in_zp = 0
// and d = 0) and "noround" (a saturating truncation of y, no clip).

#include "segment_ops.cuh"
#include "general_ops.cuh"

namespace {

enum { K_DW, K_CONV, K_PW, K_FC, K_POOL, K_SOFTMAX };

// FullyConnected: one warp an output, lanes over K, then a shuffle sum
// (integer, so the order does not matter).  Weights are [N][K].
template <int kMode>
__device__ void op_fc(const Op& op, const int8_t* src, int8_t* dst) {
  const int K = op[F_IN], N = op[F_OUT], zp = op[F_ZP], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  const int lane = threadIdx.x & 31;
  for (int n = threadIdx.x >> 5; n < N; n += kThreads / 32) {
    const int8_t* wr = w + (size_t)n * K;
    int acc = 0;
    for (int k = lane; k < K; k += 32) acc += ((int)src[k] - zp) * (int)__ldg(wr + k);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) dst[n] = out8<kMode>(acc, __ldg(b0 + n), __ldg(c1 + n), lo, hi, exact, fx);
  }
}

// Softmax over N <= 128 entries, one thread: e = f32(q) * in_s (no zero
// point, as the reference), expf, the total summed left to right, then
// ex / total / out_s + out_zp with IEEE divisions, round away, clamp.
__device__ void op_softmax(const Op& op, const int8_t* src, int8_t* dst) {
  if (threadIdx.x != 0) return;
  const int n = op[F_IN];
  const float in_s = __int_as_float(op[F_S0]), out_s = __int_as_float(op[F_S1]);
  const float zp = (float)op[F_OUTZP];
  float total = 0.0f;
  for (int i = 0; i < n; ++i) total = __fadd_rn(total, expf(__fmul_rn((float)src[i], in_s)));
  for (int i = 0; i < n; ++i) {
    const float ex = expf(__fmul_rn((float)src[i], in_s));
    dst[i] = mf_round_away(__fadd_rn(__fdiv_rn(__fdiv_rn(ex, total), out_s), zp), -128.0f,
                           127.0f);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 4)
    flat_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long B,
                const unsigned char* __restrict__ plan, int n_ops, int in_elems, int out_elems,
                int smem_a) {
  run_plan(x, out, B, plan, n_ops, in_elems, out_elems, smem_a,
           [](const Op& op, const int8_t* src, int8_t* dst) {
             switch (op[F_KIND]) {
               case K_DW:
                 switch (op[F_DW3]) {
                   case DW3_S1: op_dw3<1, kMode>(op, src, dst); break;
                   case DW3_S2: op_dw3<2, kMode>(op, src, dst); break;
                   case DW3_STEM: op_dw3_stem<kMode>(op, src, dst); break;
                   default:
                     if (op[F_VEC]) op_dw_vec<kMode>(op, src, dst);
                     else op_dw<kMode>(op, src, dst);
                 }
                 break;
               case K_CONV: op_conv<kMode>(op, src, dst); break;
               case K_PW:
                 if (op[F_MMA]) op_pw_mma<kMode>(op, src, dst);
                 else op_pw<kMode>(op, src, dst);
                 break;
               case K_FC: op_fc<kMode>(op, src, dst); break;
               case K_POOL: op_pool<kMode>(op, src, dst); break;
               default: op_softmax(op, src, dst); break;
             }
           });
}

}  // namespace

// Plain C entry point (bound with ctypes).  plan: the device buffer of
// kernels/flatpack.py::pack_plan; smem_a/smem_b: its two buffer sizes;
// mode: the F_EXACT of the plan's epilogue (kernels/flatpack.py::EPILOGUES),
// which picks the instantiation: R_EXACT2 and R_EXACT flat_kernel<R_EXACT2>,
// the others their own.  Returns the CUDA error code (0 on success); a
// launch the card refuses, for too much shared memory for example, returns
// its error here.
extern "C" int mf_flatpack(const void* x, void* out, long long B, const void* plan, int n_ops,
                           int in_elems, int out_elems, int smem_a, int smem_b, int mode,
                           void* stream) {
  if (B <= 0 || n_ops <= 0 || in_elems <= 0 || out_elems <= 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case R_EXACT2:
    case R_EXACT:
      return launch_plan(flat_kernel<R_EXACT2>, x, out, B, plan, n_ops, in_elems, out_elems,
                         smem_a, smem_b, stream);
    case R_FIXED:
      return launch_plan(flat_kernel<R_FIXED>, x, out, B, plan, n_ops, in_elems, out_elems,
                         smem_a, smem_b, stream);
    case R_RAW:
      return launch_plan(flat_kernel<R_RAW>, x, out, B, plan, n_ops, in_elems, out_elems, smem_a,
                         smem_b, stream);
    case R_NOROUND:
      return launch_plan(flat_kernel<R_NOROUND>, x, out, B, plan, n_ops, in_elems, out_elems,
                         smem_a, smem_b, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
