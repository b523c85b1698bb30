// Quantized softmax over the rows of an int8 [M, N] tensor for Hopper
// (sm_90a), the per-op path's softmax (backend "pallas"), bit-equal to the
// plain op (ops/softmax.py) and to the whole-network kernels' op_softmax
// (flatpack.cu):
//
//   e     = f32(q) * in_s                     (no zero point, as the reference)
//   total = e^e[0] + e^e[1] + ... + e^e[N-1]  (f32, left to right)
//   out   = clamp(roundf(e^e[i] / total / out_s + out_zp), -128, 127)
//
// A row whose exponentials overflow f32 makes inf / inf = NaN, which gives 0,
// as the plain op's conversion and the reference's saturating cast give.
//
// What bounds it: the order of the sum.  Each row's total is one chain of N
// dependent f32 adds (any other order rounds otherwise), so a row is one
// thread's: N expf and adds, then N more expf for the outputs.  The rows are
// independent, one thread each.  The plain op issues the chain as N
// launches over all rows (1001 for MobileNetV2's classes); here it is one.

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) qsoftmax_kernel(const int8_t* __restrict__ x,
                                                             int8_t* __restrict__ out,
                                                             long long M, int N, float in_s,
                                                             float out_s, float out_zp) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  const int8_t* src = x + row * N;
  int8_t* dst = out + row * N;
  float total = 0.0f;
  for (int i = 0; i < N; ++i) total = __fadd_rn(total, expf(__fmul_rn((float)src[i], in_s)));
  for (int i = 0; i < N; ++i) {
    const float ex = expf(__fmul_rn((float)src[i], in_s));
    const float y = __fadd_rn(__fdiv_rn(__fdiv_rn(ex, total), out_s), out_zp);
    dst[i] = isnan(y) ? (int8_t)0 : mf_round_away(y, -128.0f, 127.0f);
  }
}

}  // namespace

extern "C" int mf_qsoftmax(const void* x, void* out, long long M, int N, float in_s,
                           float out_s, int out_zp, void* stream) {
  if (M < 0 || N <= 0 || out_zp < -128 || out_zp > 127) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  qsoftmax_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), M, N, in_s, out_s,
      (float)out_zp);
  return (int)cudaGetLastError();
}
