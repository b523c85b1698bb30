// Column-FC kernel for Hopper (sm_90a): a chain of tiny FullyConnected
// layers, every width <= 32, one thread a sample.
//
// Replaces the Pallas kernel microflow_tpu/kernels/colfc.py::build_col_kernel
// (the experimental `colfc` backend).  The TPU kernel laid the batch on the
// vector lanes so that a K <= 32 product did not waste a 128-wide matrix
// unit; on the card the same idea is one thread per sample.  Each block
// copies the whole plan (every layer's W, d, bias0, c1, bounds: 2.6 KB for
// sine) into shared memory once, and each thread runs its sample through
// every layer with the activations in registers:
//
//   acc[n] = d[n] + sum_k x[k] * W_T[n][k]          (i32, or exact f32)
//   x'[n]  = exact2(bias0[n] + c1[n] * f32(acc[n]))  (csrc/epilogue.cuh)
//
// Widths are compiled in three classes (8, 16, 32) with fully unrolled
// loops, so the activation arrays stay in registers; the plan zero-pads W
// to its class and lanes past a layer's width are set to zero.
//
// What bounds it on an H100: bytes, by far, for sine (1 byte in and 1 out
// per sample against 288 multiply-adds).  The padding to the width classes
// multiplies the work (sine runs 8x16 + 16x16 + 16x8 products for
// 16 + 256 + 16), the likely cost above that bound.

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 32;
constexpr int kHeader = 8;  // K, N, K class, N class, lo bits, hi bits, offset, unused

__device__ __forceinline__ int mac(int acc, int x, int w) { return acc + x * w; }
__device__ __forceinline__ float mac(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <int KM, int NM, typename T>
__device__ __forceinline__ void layer(const T (&x)[kMax], T (&y)[kMax], const int* L, int n_real,
                                      float lo, float hi) {
  const T* w = reinterpret_cast<const T*>(L);  // [NM][KM]
  const T* d = w + NM * KM;
  const float* b0 = reinterpret_cast<const float*>(d + NM);
  const float* c1 = b0 + NM;
#pragma unroll
  for (int n = 0; n < kMax; ++n) y[n] = T(0);
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    T acc = d[n];
#pragma unroll
    for (int k = 0; k < KM; ++k) acc = mac(acc, x[k], w[n * KM + k]);
    const float v = __fadd_rn(b0[n], __fmul_rn(c1[n], to_f32(acc)));
    const int8_t q = mf_exact2(v, lo, hi);
    y[n] = n < n_real ? T(q) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void run_layer(int kc, int nc, const T (&x)[kMax], T (&y)[kMax],
                                          const int* L, int n_real, float lo, float hi) {
  switch (kc * 64 + nc) {
    case 8 * 64 + 8: layer<8, 8>(x, y, L, n_real, lo, hi); break;
    case 8 * 64 + 16: layer<8, 16>(x, y, L, n_real, lo, hi); break;
    case 8 * 64 + 32: layer<8, 32>(x, y, L, n_real, lo, hi); break;
    case 16 * 64 + 8: layer<16, 8>(x, y, L, n_real, lo, hi); break;
    case 16 * 64 + 16: layer<16, 16>(x, y, L, n_real, lo, hi); break;
    case 16 * 64 + 32: layer<16, 32>(x, y, L, n_real, lo, hi); break;
    case 32 * 64 + 8: layer<32, 8>(x, y, L, n_real, lo, hi); break;
    case 32 * 64 + 16: layer<32, 16>(x, y, L, n_real, lo, hi); break;
    default: layer<32, 32>(x, y, L, n_real, lo, hi); break;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) col_kernel(const int8_t* __restrict__ x,
                                                       int8_t* __restrict__ out, long long B,
                                                       const int* __restrict__ plan, int n_layers,
                                                       int plan_words, int k0, int n_out) {
  extern __shared__ int splan[];
  for (int i = threadIdx.x; i < plan_words; i += kThreads) splan[i] = __ldg(plan + i);
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long b = (long long)blockIdx.x * kThreads + threadIdx.x; b < B; b += stride) {
    T a[kMax], c[kMax];
    const int8_t* xr = x + b * k0;
#pragma unroll
    for (int k = 0; k < kMax; ++k) a[k] = k < k0 ? T(__ldg(xr + k)) : T(0);
    for (int l = 0; l < n_layers; ++l) {
      const int* h = splan + l * kHeader;
      run_layer<T>(h[2], h[3], a, c, splan + h[6], h[1], __int_as_float(h[4]),
                   __int_as_float(h[5]));
#pragma unroll
      for (int k = 0; k < kMax; ++k) a[k] = c[k];
    }
    int8_t* orow = out + b * n_out;
#pragma unroll
    for (int n = 0; n < kMax; ++n)
      if (n < n_out) orow[n] = (int8_t)a[n];
  }
}

template <typename T>
cudaError_t launch(const int8_t* x, int8_t* out, long long B, const int* plan, int n_layers,
                   int plan_words, int k0, int n_out, cudaStream_t stream) {
  const int smem = plan_words * 4;
  cudaError_t err =
      cudaFuncSetAttribute(col_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, col_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (B + kThreads - 1) / kThreads;
  const long long grid = need < (long long)per_sm * sms ? need : (long long)per_sm * sms;
  col_kernel<T><<<(unsigned)grid, kThreads, smem, stream>>>(x, out, B, plan, n_layers, plan_words,
                                                            k0, n_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  plan: the int32 buffer of
// kernels/colfc.py::pack_col_plan (plan_words words).  f32: accumulate in
// f32 (the plan then holds W and d as f32).  Returns the CUDA error code.
extern "C" int mf_colfc(const void* x, void* out, long long B, const void* plan, int n_layers,
                        int plan_words, int k0, int n_out, int f32, void* stream) {
  if (B <= 0 || n_layers <= 0 || k0 <= 0 || k0 > kMax || n_out <= 0 || n_out > kMax)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  auto* op = static_cast<int8_t*>(out);
  const auto* pp = static_cast<const int*>(plan);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? launch<float>(xp, op, B, pp, n_layers, plan_words, k0, n_out, s)
                   : launch<int>(xp, op, B, pp, n_layers, plan_words, k0, n_out, s));
}
