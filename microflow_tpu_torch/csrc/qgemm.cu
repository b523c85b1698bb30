// Fused int8 GEMM + requantization + activation for Hopper (sm_90a).
//
// Replaces the Pallas kernel microflow_tpu/kernels/qgemm.py::qgemm
// (body _qgemm_kernel).  It serves FullyConnected directly and Conv2D after
// im2col; for the 1x1 convs of MobileNet the im2col is a reshape.
//
//   acc[m,n] = sum_k X[m,k] * W[k,n]                        (int8 x int8 -> i32)
//   q[m,n]   = acc - rowsum(X)[m] * wzp[n] + d[n]           (i32, exact)
//   y[m,n]   = roundf(bias0[n] + c1[n] * f32(q))            (f32 mul, then add)
//   out      = clip(y, lo, hi) as int8                      (activation folded in)
//
// What bounds it on an H100: bytes.  The shapes it serves have K = 1..256
// (and 4000 once, with N = 4), so each X byte feeds at most N <= 256
// multiply-adds; at int8 rates that is far below the ~600 operations per
// byte where the tensor cores would become the limit.  The design therefore
// reads X once through shared memory in coalesced words, keeps all
// accumulators in registers, and applies the epilogue before a single int8
// store: no i32 tensor touches device memory.  The tile adapts to narrow N
// (BN = 16, 32 or 64) and to short K (BK = 4 .. 32 bytes) so little of the
// block's work is padding.  Products use __dp4a (four int8 products and a
// sum in one instruction); the row sums ride along as dp4a against ones.
// Without tensor cores, the widest layers (K = N = 256) run out of integer
// issue rate well before bytes; a tensor-core path is later work.
//
// Rounding: the epilogue is written with __fmul_rn/__fadd_rn, and the file is
// built with -fmad=false, so bias0 + c1*q is a multiply and then an add, as in
// the reference, never one fused multiply-add.  roundf rounds half away from
// zero.  y is clamped in f32 before the conversion, which is then exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BN, int BK>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ wzp, const int32_t* __restrict__ d,
    const float* __restrict__ bias0, const float* __restrict__ c1,
    int8_t* __restrict__ out, long long M, int K, int N, float lo, float hi,
    int vec_x, int vec_out) {
  constexpr int TM = 4, TN = 4;       // outputs per thread: TM rows x TN columns
  constexpr int TX = BN / TN;         // threads along N
  constexpr int TY = kThreads / TX;   // threads along M
  constexpr int BM = TY * TM;         // rows per block
  constexpr int KW = BK / 4;          // 32-bit words per row of a K slice
  constexpr int LD = KW + 1;          // padded shared-memory row stride (words)
  __shared__ int32_t xs[BM * LD];     // X tile, row-major
  __shared__ int32_t ws[BN * LD];     // W tile, transposed: column n's K bytes packed

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int acc[TM][TN];
  int rs[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rs[i] = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // X tile [BM rows][BK bytes]; bytes past M or K are zero, which adds
    // nothing to acc or to the row sums.
    for (int e = tid; e < BM * KW; e += kThreads) {
      const int r = e / KW, c = e % KW;
      const long long m = m0 + r;
      const int k = k0 + 4 * c;
      uint32_t v = 0;
      if (m < M && k < K) {
        const int8_t* p = x + m * K + k;
        if (vec_x) {
          v = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (k + b < K) v |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * b);
        }
      }
      xs[r * LD + c] = (int32_t)v;
    }
    // W tile, transposed so each column's 4 consecutive K bytes form a word.
    for (int e = tid; e < BN * KW; e += kThreads) {
      const int n = e % BN, c = e / BN;
      uint32_t v = 0;
      if (n0 + n < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k0 + 4 * c + b;
          if (k < K) v |= (uint32_t)(uint8_t)__ldg(w + (long long)k * N + n0 + n) << (8 * b);
        }
      }
      ws[n * LD + c] = (int32_t)v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      int xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[(i * TY + ty) * LD + c];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[(tx * TN + j) * LD + c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        rs[i] = __dp4a(xv[i], 0x01010101, rs[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: requantize, clip to the activation bounds, one int8 store.
  const int nb = n0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + i * TY + ty;
    if (m >= M) continue;
    uint32_t packed = 0;
    int8_t vals[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = nb + j;
      vals[j] = 0;
      if (n < N) {
        const int q = acc[i][j] - rs[i] * __ldg(wzp + n) + __ldg(d + n);
        float y = __fadd_rn(__ldg(bias0 + n), __fmul_rn(__ldg(c1 + n), __int2float_rn(q)));
        y = fminf(fmaxf(roundf(y), lo), hi);
        vals[j] = (int8_t)(int)y;
      }
      packed |= (uint32_t)(uint8_t)vals[j] << (8 * j);
    }
    int8_t* o = out + m * N + nb;
    if (vec_out && nb + TN <= N) {
      *reinterpret_cast<uint32_t*>(o) = packed;
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (nb + j < N) o[j] = vals[j];
    }
  }
}

template <int BN, int BK>
cudaError_t launch(const int8_t* x, const int8_t* w, const int32_t* wzp, const int32_t* d,
                   const float* bias0, const float* c1, int8_t* out, long long M, int K, int N,
                   float lo, float hi, int vec_x, int vec_out, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / 4)) * 4;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  qgemm_kernel<BN, BK><<<grid, kThreads, 0, stream>>>(x, w, wzp, d, bias0, c1, out, M, K, N, lo,
                                                      hi, vec_x, vec_out);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bk(const int8_t* x, const int8_t* w, const int32_t* wzp, const int32_t* d,
                      const float* bias0, const float* c1, int8_t* out, long long M, int K, int N,
                      float lo, float hi, int vec_x, int vec_out, cudaStream_t s) {
  if (K <= 4) return launch<BN, 4>(x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, vec_x, vec_out, s);
  if (K <= 8) return launch<BN, 8>(x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, vec_x, vec_out, s);
  if (K <= 16) return launch<BN, 16>(x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, vec_x, vec_out, s);
  return launch<BN, 32>(x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, vec_x, vec_out, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch, 0 on success.  vec_x: K % 4 == 0 and x 4-byte aligned.
// vec_out: N % 4 == 0 and out 4-byte aligned.
extern "C" int mf_qgemm(const void* x, const void* w, const void* wzp, const void* d,
                        const void* bias0, const void* c1, void* out, long long M, int K, int N,
                        float lo, float hi, int vec_x, int vec_out, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* zp = static_cast<const int32_t*>(wzp);
  const auto* dp = static_cast<const int32_t*>(d);
  const auto* bp = static_cast<const float*>(bias0);
  const auto* cp = static_cast<const float*>(c1);
  auto* op = static_cast<int8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 16)
    err = launch_bk<16>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_x, vec_out, s);
  else if (N <= 32)
    err = launch_bk<32>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_x, vec_out, s);
  else
    err = launch_bk<64>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_x, vec_out, s);
  return (int)err;
}
