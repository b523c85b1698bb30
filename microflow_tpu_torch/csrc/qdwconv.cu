// Fused int8 depthwise conv + requantization + activation for Hopper (sm_90a).
//
// Replaces the Pallas kernel microflow_tpu/kernels/qdwconv.py::qdwconv
// (body _qdwconv_kernel).  The input arrives padded with the input zero
// point and the weights centred (w - w_zp[c], i32), so
//
//   q[b,i,j,c] = sum_mn xp[b, sr*i+m, sc*j+n, c] * wc[m,n,c] + d[c]
//   y          = roundf(bias0[c] + c1[c] * f32(q))          (f32 mul, then add)
//   out        = clip(y, lo, hi) as int8                    (activation folded in)
//
// What bounds it on an H100: bytes.  There is no contraction over channels:
// each output costs KH*KW multiply-adds against about one input byte and one
// output byte.  One thread computes one output pixel for V = 4 consecutive
// channels (channels are the fastest axis, so a warp reads neighbouring
// words), reads each tap as one 32-bit word and its four centred weights as
// one 16-byte load, and stores its four int8 results as one word.  Taps that
// overlap between neighbouring outputs are served from L1/L2, so device
// memory sees roughly one read of the input and one write of the output.
// The stride is applied directly in the address: the TPU kernel's
// phase-plane split only worked around Mosaic's ban on strided slices.
//
// Rounding and casts as in qgemm.cu: __fmul_rn/__fadd_rn and -fmad=false
// keep the multiply and the add apart; roundf rounds half away from zero;
// the clamp comes before the conversion.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t requant(int q, float b, float s, float lo, float hi) {
  float y = __fadd_rn(b, __fmul_rn(s, __int2float_rn(q)));
  y = fminf(fmaxf(roundf(y), lo), hi);
  return (int8_t)(int)y;
}

// V channels per thread: 4 when C % 4 == 0 (word loads and stores), else 1.
template <int V>
__global__ void __launch_bounds__(kThreads) qdwconv_kernel(
    const int8_t* __restrict__ xp, const int32_t* __restrict__ wc,
    const int32_t* __restrict__ d, const float* __restrict__ bias0,
    const float* __restrict__ c1, int8_t* __restrict__ out, long long total, int HP, int WP,
    int C, int KH, int KW, int SR, int SC, int OH, int OW, float lo, float hi) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int cv = C / V;
  const int c = (int)(idx % cv) * V;
  long long p = idx / cv;
  const int j = (int)(p % OW);
  p /= OW;
  const int i = (int)(p % OH);
  const long long b = p / OH;

  int acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0;

  const int8_t* base = xp + ((b * HP + (long long)i * SR) * WP + (long long)j * SC) * C + c;
  for (int m = 0; m < KH; ++m) {
    const int8_t* row = base + (long long)m * WP * C;
    const int32_t* wrow = wc + (long long)m * KW * C + c;
    for (int n = 0; n < KW; ++n) {
      if constexpr (V == 4) {
        const char4 xv = __ldg(reinterpret_cast<const char4*>(row + (long long)n * C));
        const int4 wv = __ldg(reinterpret_cast<const int4*>(wrow + n * C));
        acc[0] += (int)xv.x * wv.x;
        acc[1] += (int)xv.y * wv.y;
        acc[2] += (int)xv.z * wv.z;
        acc[3] += (int)xv.w * wv.w;
      } else {
        acc[0] += (int)__ldg(row + (long long)n * C) * __ldg(wrow + n * C);
      }
    }
  }

  int8_t* o = out + idx * V;  // output [B, OH, OW, C] in the thread order
  if constexpr (V == 4) {
    uint32_t packed = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int8_t r = requant(acc[v] + __ldg(d + c + v), __ldg(bias0 + c + v),
                               __ldg(c1 + c + v), lo, hi);
      packed |= (uint32_t)(uint8_t)r << (8 * v);
    }
    *reinterpret_cast<uint32_t*>(o) = packed;
  } else {
    o[0] = requant(acc[0] + __ldg(d + c), __ldg(bias0 + c), __ldg(c1 + c), lo, hi);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch, 0 on success.  vec: C % 4 == 0 and xp, out 4-byte aligned,
// wc 16-byte aligned.
extern "C" int mf_qdwconv(const void* xp, const void* wc, const void* d, const void* bias0,
                          const void* c1, void* out, int B, int HP, int WP, int C, int KH, int KW,
                          int SR, int SC, int OH, int OW, float lo, float hi, int vec,
                          void* stream) {
  if (B <= 0 || C <= 0 || OH <= 0 || OW <= 0 || KH <= 0 || KW <= 0 || SR <= 0 || SC <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)SR * (OH - 1) + KH > HP || (long long)SC * (OW - 1) + KW > WP)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(xp);
  const auto* w = static_cast<const int32_t*>(wc);
  const auto* dd = static_cast<const int32_t*>(d);
  const auto* bb = static_cast<const float*>(bias0);
  const auto* cc = static_cast<const float*>(c1);
  auto* o = static_cast<int8_t*>(out);
  const long long pixels = (long long)B * OH * OW;
  if (vec) {
    const long long total = pixels * (C / 4);
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    qdwconv_kernel<4><<<blocks, kThreads, 0, s>>>(x, w, dd, bb, cc, o, total, HP, WP, C, KH, KW,
                                                  SR, SC, OH, OW, lo, hi);
  } else {
    const long long total = pixels * C;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    qdwconv_kernel<1><<<blocks, kThreads, 0, s>>>(x, w, dd, bb, cc, o, total, HP, WP, C, KH, KW,
                                                  SR, SC, OH, OW, lo, hi);
  }
  return (int)cudaGetLastError();
}
