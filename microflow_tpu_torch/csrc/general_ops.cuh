// The general op paths of the flat kernel's plan, one output (or four
// channels of one pixel) a thread, shared by csrc/flatpack.cu and
// csrc/packed.cu: they take what the shared paths of segment_ops.cuh
// refuse by shape (kernels/flatpack.py::pack_plan marks none of F_DW3,
// F_VEC, F_MMA): a depthwise conv over a channel count those paths do not
// take, any Conv2D, and a 1x1 conv over a multiple of 4 channels off the
// tensor cores (op_pw).  Every read stays in bounds: a tap outside
// the input is skipped, so the sum is over in-bounds taps (x - in_zp) * w,
// as in the reference; a 1x1 window is always in bounds, and op_pw adds
// d = -in_zp * colsum to the raw int8 dot.  kMode is the instantiation's
// epilogue (segment_ops.cuh: out8).

#pragma once

#include "segment_ops.cuh"

namespace {

// Depthwise conv, one output a thread (the general case); output channel c
// reads input channel c, or channel 0 when the input has fewer channels
// (the depth-multiplier fallback).
template <int kMode = R_EXACT2>
__device__ void op_dw(const Op& op, const int8_t* src, int8_t* dst) {
  const int ih = op[F_IH], iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int kh = op[F_KH], kw = op[F_KW], sr = op[F_SR], sc = op[F_SC];
  const int pt = op[F_PT], pl = op[F_PL], zp = op[F_ZP], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);  // [KH][KW][OC]
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
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
        acc += ((int)src[(r * iw + q) * ic + ci] - zp) * (int)__ldg(w + (dh * kw + dw) * oc + c);
      }
    }
    dst[e] = out8<kMode>(acc, __ldg(b0 + c), __ldg(c1 + c), lo, hi, exact, fx);
  }
}

// Any Conv2D: filters [OC][KH][KW][IC].
template <int kMode = R_EXACT2>
__device__ void op_conv(const Op& op, const int8_t* src, int8_t* dst) {
  const int ih = op[F_IH], iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int kh = op[F_KH], kw = op[F_KW], sr = op[F_SR], sc = op[F_SC];
  const int pt = op[F_PT], pl = op[F_PL], zp = op[F_ZP], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int8_t* w = op.at<int8_t>(F_W);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  const int total = oh * ow * oc;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int f = e % oc, p = e / oc;
    const int r0 = (p / ow) * sr - pt, q0 = (p % ow) * sc - pl;
    int acc = 0;
    for (int dh = 0; dh < kh; ++dh) {
      const int r = r0 + dh;
      if (r < 0 || r >= ih) continue;
      for (int dw = 0; dw < kw; ++dw) {
        const int q = q0 + dw;
        if (q < 0 || q >= iw) continue;
        const int8_t* xs = src + (r * iw + q) * ic;
        const int8_t* ws = w + ((f * kh + dh) * kw + dw) * ic;
        for (int ci = 0; ci < ic; ++ci) acc += ((int)xs[ci] - zp) * (int)__ldg(ws + ci);
      }
    }
    dst[e] = out8<kMode>(acc, __ldg(b0 + f), __ldg(c1 + f), lo, hi, exact, fx);
  }
}

// 1x1 conv (any stride) over IC % 4 == 0 channels: raw int8 dot by __dp4a
// plus d[f] = -in_zp * colsum.  Weights are [IC/4][OC] words.
template <int kMode = R_EXACT2>
__device__ void op_pw(const Op& op, const int8_t* src, int8_t* dst) {
  const int iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int sr = op[F_SR], sc = op[F_SC], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int* w4 = op.at<int>(F_W);
  const int* d = op.at<int>(F_D);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  const int k4 = ic >> 2;
  if ((oc & 3) == 0) {
    // four output channels a thread: one x word feeds four __dp4a, and the
    // four weight words arrive in one 16-byte load
    const int groups = oc >> 2;
    const int total = oh * ow * groups;
    const int4* wv4 = reinterpret_cast<const int4*>(w4);
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int g = e % groups, p = e / groups;
      const int ip = (p / ow) * sr * iw + (p % ow) * sc;
      const int* xw = reinterpret_cast<const int*>(src + ip * ic);
      int acc[4] = {0, 0, 0, 0};
      for (int k = 0; k < k4; ++k) {
        const int xv = xw[k];
        const int4 wv = __ldg(wv4 + k * groups + g);
        acc[0] = __dp4a(xv, wv.x, acc[0]);
        acc[1] = __dp4a(xv, wv.y, acc[1]);
        acc[2] = __dp4a(xv, wv.z, acc[2]);
        acc[3] = __dp4a(xv, wv.w, acc[3]);
      }
      const int c = 4 * g;
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= (uint32_t)(uint8_t)out8<kMode>(acc[j] + __ldg(d + c + j), __ldg(b0 + c + j),
                                                 __ldg(c1 + c + j), lo, hi, exact, fx)
                  << (8 * j);
      *reinterpret_cast<uint32_t*>(dst + p * oc + c) = packed;
    }
  } else {
    const int total = oh * ow * oc;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int c = e % oc, p = e / oc;
      const int ip = (p / ow) * sr * iw + (p % ow) * sc;
      const int* xw = reinterpret_cast<const int*>(src + ip * ic);
      int acc = 0;
      for (int k = 0; k < k4; ++k) acc = __dp4a(xw[k], __ldg(w4 + k * oc + c), acc);
      dst[e] = out8<kMode>(acc + __ldg(d + c), __ldg(b0 + c), __ldg(c1 + c), lo, hi, exact, fx);
    }
  }
}

}  // namespace
