// Requantization epilogues shared by the whole-network kernels
// (flatpack.cu, colfc.cu, megakernel.cu, packed.cu).  Built with -fmad=false; the multiply and the add
// are also spelled __fmul_rn/__fadd_rn, so y = bias0 + c1*f32(acc) rounds
// twice, as in the reference, never as one fused multiply-add (and so does
// the fixed-point epilogue's f32(q) * m + 0.5).
//
// lo and hi are the activation's clip bounds already intersected with the
// int8 range.  A float->int8 conversion out of range is undefined in C++,
// so every path clamps in f32 first; the clamped value is integral and the
// truncating conversion is then exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float mf_affine(float bias0, float c1, int acc) {
  return __fadd_rn(bias0, __fmul_rn(c1, __int2float_rn(acc)));
}

// The TPU kernels' "exact2": round half away from zero folded into a
// truncation, trunc(y + (y >= 0 ? 0.5 : -0.5)).  It differs from roundf at
// y = +-(0.5 - 2^-25), where the add rounds up to +-1.
__device__ __forceinline__ int8_t mf_exact2(float y, float lo, float hi) {
  const float t = __fadd_rn(y, y >= 0.0f ? 0.5f : -0.5f);
  return (int8_t)__float2int_rz(fminf(fmaxf(t, lo), hi));
}

// The TPU kernel's measurement-only "noround": y cast to int8 by a
// truncation toward zero that saturates (Mosaic's f32->int8 convert), with
// no round and no activation clip: the clamp to the int8 range in f32 first,
// then the truncating conversion, which is then exact.
__device__ __forceinline__ int8_t mf_trunc_sat(float y) {
  return (int8_t)__float2int_rz(fminf(fmaxf(y, -128.0f), 127.0f));
}

// roundf (half away from zero), then the clamp: the reference's own rule
// ("exact", pool, softmax).
__device__ __forceinline__ int8_t mf_round_away(float y, float lo, float hi) {
  return (int8_t)__float2int_rz(fminf(fmaxf(roundf(y), lo), hi));
}

// The fixed-point (M, S) requant of core/fixedpoint.py, as the TPU kernel's
// "fixed" epilogue: q = acc + bias_q in i32, p = f32(q) * m with m =
// M * 2^-S, t = p + (p >= 0 ? 0.5 : -0.5), then out_zp after the rounding:
// clip(trunc(t) + zp, lo, hi).  Here lo and hi are the clip bounds less zp,
// so that is trunc(clip(t, lo, hi)) + zp (both bounds are integers): two
// conversions an output, as mf_exact2's chain.
__device__ __forceinline__ int8_t mf_fixed(int q, float m, int zp, float lo, float hi) {
  const float p = __fmul_rn(__int2float_rn(q), m);
  const float t = __fadd_rn(p, p >= 0.0f ? 0.5f : -0.5f);
  return (int8_t)(__float2int_rz(fminf(fmaxf(t, lo), hi)) + zp);
}
