// Device code shared by the whole-network kernels flatpack.cu,
// megakernel.cu and packed.cu: the op descriptor their plans write, the
// persistent block loop over samples, its launch, the op paths that do the
// bulk of the work, and the host check of what those paths assume.  The
// plans (kernels/flatpack.py::pack_plan, which kernels/packed.py also
// uses, and kernels/megakernel.py::pack_segment) mark the ops that take
// these paths by rules on shape fixed at plan time
// (kernels/flatpack.py::pw_mma, dw3_path, dw_vec), so a kernel dispatches
// on descriptor fields, never on data.
//
// The loop: a persistent block takes one sample at a time (b = blockIdx.x;
// b < B; b += gridDim.x), stages its input row in shared memory, and runs
// op after op between two ping-pong shared-memory buffers (each sized to
// the largest tensor of its parity; 18,432 + 36,864 bytes for
// person_detect, so four blocks an SM), with __syncthreads() between ops.
// The only device-memory traffic is the input row, the output row, and the
// plan, which stays in L2.
//
// The 1x1 convs with a multiple of 16 output channels (op_pw_mma; the plan
// marks them F_MMA) run on the int8 tensor cores: mma.sync m16n8k32,
// output channels on M, pixels on N.  The plan holds the weights already
// in A fragment order, so a lane loads its whole fragment with one 16-byte
// load and a warp 512 contiguous bytes; B comes straight from the pixel
// rows in shared memory, which are [pixel][channel], the "col" layout as
// they are.  Each weight fragment serves NT tiles of 8 pixels.  Within
// each 64 channels the K order is permuted (the same way in A at plan time
// and in B here; an integer sum does not depend on it), so a lane reads 16
// contiguous bytes of its pixel for two k-steps: one LDS.128 in place of
// four 8-way conflicting 4-byte reads when IC >= 128.  What is left to pace
// them is the epilogue's two conversions an output on the SM's 16-a-clock
// conversion pipe, mma.sync's rate and latency (chip_smoke.py phase 3 times
// the epilogue's share through the raw and noround modes).
//
// The 3x3 depthwise convs (op_dw3, op_dw3_stem; the plan marks them
// F_DW3) make many outputs for few multiply-adds, so what paces them is
// instructions an output, not operations.  A thread keeps one group of
// four channels for the whole op, its taps and epilogue constants in
// registers, and takes a strip of adjacent output pixels of one row: each
// input word it reads serves every output of the strip whose window holds
// it, and the taps are unrolled, with bounds tested once per column and
// row, not per tap.  Other depthwise convs over a multiple of 4 channels
// (F_VEC) take op_dw_vec, four channels a thread, one pixel at a time.
//
// The taps of these paths are int8 and the 1x1 path has no weight zero
// point: the megakernel's plan centres the depthwise taps (w - w_zp) and
// takes these paths only where the centred taps fit int8 and, for a 1x1
// conv, every w_zp is 0.  Every read stays in bounds: a tap outside the
// input reads in_zp in place of the input, and d[c] = -in_zp * the sum of
// all of c's taps removes it again, so the sum is sum over in-bounds taps
// (x - in_zp) * w, as in the reference.  Epilogues: epilogue.cuh, the
// rounding chosen per op by F_EXACT (round half away from zero, or
// exact2).  The op paths take the instantiation's epilogue as a template
// mode (kMode): R_EXACT2, the default and the only one the megakernel and
// the packed kernel instantiate, rounds as F_EXACT says at run time
// (requant); the flat kernel's other instantiations take one epilogue on
// every path, F_EXACT naming it in their plans too.  R_FIXED is the (M, S)
// epilogue: an op's F_BIAS words then hold bias_q as i32 and its F_C1 words
// m = M * 2^-S.  R_RAW and R_NOROUND are the TPU kernel's measurement-only
// modes: R_RAW stores the low byte of the accumulator (its plan packs
// in_zp = 0 and d = 0, so every path's sum is the JAX plan's accumulator,
// sum over in-bounds taps x * w, which is q less the JAX plan's d), and a
// pool its sum's low byte; R_NOROUND truncates y = bias0 + c1 * f32(q)
// toward zero, saturating, with no round and no activation clip.

#pragma once

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int NT = 3;   // tiles of 8 pixels a warp's work item in op_pw_mma
constexpr int NF = 32;  // int32 fields per op descriptor (kernels/flatpack.py)
// The descriptor's fields.  Both plans write this layout; F_WZP (the
// megakernel's per-channel weight zero points) is the megakernel's own.
enum {
  F_KIND, F_IH, F_IW, F_IC, F_OH, F_OW, F_OC, F_KH, F_KW, F_SR, F_SC, F_PT, F_PL, F_ZP, F_LO,
  F_HI, F_W, F_D, F_BIAS, F_C1, F_RECIP, F_S0, F_S1, F_OUTZP, F_EXACT, F_IN, F_OUT, F_VEC, F_MMA,
  F_DW3, F_WZP
};
enum { DW3_NONE, DW3_S1, DW3_S2, DW3_STEM };  // F_DW3: which 3x3 depthwise path
// F_EXACT: the epilogue of a conv, dw or fc op
enum { R_EXACT2, R_EXACT, R_FIXED, R_RAW, R_NOROUND };
constexpr int DW_STRIP = 3;    // output pixels a work item of op_dw3
constexpr int STEM_STRIP = 4;  // output pixels a work item of op_dw3_stem
// The most elements a tensor of an F_MMA or F_DW3 op may have: Div16's
// domain.
constexpr int MAX_LANES = 65536;

struct Op {
  const int* f;
  const unsigned char* plan;
  __device__ int operator[](int i) const { return __ldg(f + i); }
  template <typename T>
  __device__ const T* at(int field) const {
    return reinterpret_cast<const T*>(plan + __ldg(f + field));
  }
};

__device__ __forceinline__ int8_t requant(int acc, float b0, float c1, float lo, float hi,
                                          int exact) {
  const float y = mf_affine(b0, c1, acc);
  return exact ? mf_round_away(y, lo, hi) : mf_exact2(y, lo, hi);
}

// One output of epilogue kMode (R_EXACT2, R_EXACT, R_FIXED, R_RAW or
// R_NOROUND) from the accumulator and the channel's F_BIAS and F_C1 words;
// for R_FIXED, lo and hi are the bounds less zp (Fixed).
template <int kMode>
__device__ __forceinline__ int8_t epilogue(int acc, float b0, float c1, float lo, float hi,
                                           int zp) {
  if constexpr (kMode == R_FIXED) {
    return mf_fixed(acc + __float_as_int(b0), c1, zp, lo, hi);
  } else if constexpr (kMode == R_RAW) {
    return (int8_t)acc;
  } else {
    const float y = mf_affine(b0, c1, acc);
    if constexpr (kMode == R_NOROUND) return mf_trunc_sat(y);
    return kMode == R_EXACT ? mf_round_away(y, lo, hi) : mf_exact2(y, lo, hi);
  }
}

// An op's fixed-point epilogue: out_zp and the clip bounds less out_zp,
// loaded once; (acc, the channel's F_BIAS and F_C1 words) -> int8.  The sum
// acc + bias_q wraps in i32, as the TPU kernel's acc + (d + bias_q).
struct Fixed {
  int zp = 0;
  float lo = 0.0f, hi = 0.0f;
  Fixed() = default;
  __device__ explicit Fixed(const Op& op)
      : zp(op[F_OUTZP]), lo((float)(op[F_LO] - zp)), hi((float)(op[F_HI] - zp)) {}
  __device__ int8_t operator()(int acc, float bias_q, float m) const {
    return epilogue<R_FIXED>(acc, bias_q, m, lo, hi, zp);
  }
};

// One output of an op path instantiated for kMode: under R_EXACT2 the op's
// F_EXACT rounding, picked at run time (requant); else kMode's epilogue.
template <int kMode>
__device__ __forceinline__ int8_t out8(int acc, float b0, float c1, float lo, float hi, int exact,
                                       const Fixed& fx) {
  if constexpr (kMode == R_FIXED) return fx(acc, b0, c1);
  else if constexpr (kMode == R_EXACT2) return requant(acc, b0, c1, lo, hi, exact);
  else return epilogue<kMode>(acc, b0, c1, lo, hi, 0);
}

// Depthwise conv, four channels a thread (OC % 4 == 0, IC == OC or IC == 1,
// OC/4 dividing the block): each thread keeps one group of four channels,
// so its epilogue constants stay in registers.  Taps go four at a time: the
// four taps' channel words are transposed into one word per channel and
// multiplied by __dp4a against the plan's [ceil(KH*KW/4)][OC] words of
// four taps each.  A tap outside the input reads in_zp, and d[c] =
// -in_zp * sum of all taps' w removes it again: the sum is then
// sum over in-bounds taps (x - in_zp) * w, exactly.
template <int kMode = R_EXACT2>
__device__ void op_dw_vec(const Op& op, const int8_t* src, int8_t* dst) {
  const int ih = op[F_IH], iw = op[F_IW], ic = op[F_IC];
  const int oh = op[F_OH], ow = op[F_OW], oc = op[F_OC];
  const int kh = op[F_KH], kw = op[F_KW], sr = op[F_SR], sc = op[F_SC];
  const int pt = op[F_PT], pl = op[F_PL], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const uint32_t zpw = __byte_perm((uint32_t)op[F_ZP], 0, 0x0000);
  const int groups = oc >> 2, g = threadIdx.x % groups, c0 = 4 * g;
  const int taps = kh * kw, n4 = (taps + 3) >> 2;
  const int4* w4 = op.at<int4>(F_W) + g;
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  int d[4];
  float b0[4], c1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j] = __ldg(op.at<int>(F_D) + c0 + j);
    b0[j] = __ldg(op.at<float>(F_BIAS) + c0 + j);
    c1[j] = __ldg(op.at<float>(F_C1) + c0 + j);
  }
  const int total = oh * ow;
  for (int p = threadIdx.x / groups; p < total; p += kThreads / groups) {
    const int r0 = (p / ow) * sr - pt, q0 = (p % ow) * sc - pl;
    int acc[4] = {0, 0, 0, 0};
    int dh = 0, dw = 0;
    for (int i = 0; i < n4; ++i) {
      uint32_t t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t[j] = 0;  // a padding tap: its weight is 0
        if (4 * i + j < taps) {
          const int r = r0 + dh, q = q0 + dw;
          t[j] = zpw;
          if ((unsigned)r < (unsigned)ih && (unsigned)q < (unsigned)iw) {
            const int pix = r * iw + q;
            t[j] = ic == 1 ? __byte_perm((uint32_t)(uint8_t)src[pix], 0, 0x0000)
                           : *reinterpret_cast<const uint32_t*>(src + pix * ic + c0);
          }
          if (++dw == kw) {
            dw = 0;
            ++dh;
          }
        }
      }
      uint32_t xw[4];
      transpose4(t, xw);
      const int4 wv = __ldg(w4 + i * groups);
      acc[0] = __dp4a((int)xw[0], wv.x, acc[0]);
      acc[1] = __dp4a((int)xw[1], wv.y, acc[1]);
      acc[2] = __dp4a((int)xw[2], wv.z, acc[2]);
      acc[3] = __dp4a((int)xw[3], wv.w, acc[3]);
    }
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      packed |= (uint32_t)(uint8_t)out8<kMode>(acc[j] + d[j], b0[j], c1[j], lo, hi, exact, fx)
                << (8 * j);
    *reinterpret_cast<uint32_t*>(dst + p * oc + c0) = packed;
  }
}

// N words (4N channels from channel c) of the pixel row at src + off; a
// word of channels >= ic, or of an absent pixel (off < 0), is 0 and not
// read.  A row of a multiple of 4N channels is read with one vector load.
template <int N>
__device__ __forceinline__ void row_words(const int8_t* src, int off, int c, int ic,
                                          uint32_t (&w)[N]) {
  if (off >= 0 && ic % (4 * N) == 0 && c < ic) {
    if constexpr (N == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + off + c);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(src + off + c);
      w[0] = v.x, w[1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = off >= 0 && c + 4 * i < ic ? *reinterpret_cast<const uint32_t*>(src + off + c + 4 * i)
                                        : 0u;
  }
}

// n / d for 0 <= n < 2^16 and 1 <= d <= 2^16 (a plan's tensors have at
// most MAX_LANES = 2^16 elements, so op_pw_mma's pixel indices, widths and
// work items stay below that) by a multiply, not a division on the
// conversion pipe that the epilogues load: with M = ceil(2^32 / d) = hi * 2^32 + lo
// (hi = 1 only for d = 1), (n * M) >> 32 is exactly n / d, since
// M * d - 2^32 < d and n < 2^16 <= 2^32 / d.
struct Div16 {
  unsigned lo;
  bool hi;
  __device__ explicit Div16(int d) : lo(0xffffffffu / (unsigned)d + 1u), hi(d == 1) {}
  __device__ int operator()(int n) const {
    return (int)(__umulhi((unsigned)n, lo) + (hi ? (unsigned)n : 0u));
  }
};

// op_pw_mma's epilogue, chosen once per item, not per output: a lane's
// accumulators hold pixels p0 + 8j + i (i = 0, 1) of output channels r0
// (registers 0, 1) and r0 + 8 (registers 2, 3).
template <int kMode>
__device__ __forceinline__ void store_tiles(const int (&acc)[NT][4], int8_t* dst, int p0, int np,
                                            int oc, int r0, float b0g, float b0h, float c1g,
                                            float c1h, float lo, float hi, int zp) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = p0 + 8 * j + i;
      if (p < np) {
        dst[p * oc + r0] = epilogue<kMode>(acc[j][i], b0g, c1g, lo, hi, zp);
        dst[p * oc + r0 + 8] = epilogue<kMode>(acc[j][2 + i], b0h, c1h, lo, hi, zp);
      }
    }
  }
}

// 1x1 conv (any stride) with OC % 16 == 0 and IC % 4 == 0 on the tensor
// cores: the raw int8 dot plus d[f] = -in_zp * colsum, as op_pw, then the
// same epilogue, so the bits are op_pw's.  A warp's work item is one m-tile
// of 16 output channels and NT tiles of 8 output pixels; items stride by
// warp.  K goes in steps of 32 channels, each an "A unit" of the plan
// ([OC/16][ceil(IC/32)][32 lanes][16 bytes]); while 33 or more channels
// remain, two units cover 64 channels kb.., and lane t reads channels
// kb+16t..kb+16t+15 of its pixel (b0, b1 of the first unit, then of the
// second); else one unit covers the last <= 32 and lane t reads channels
// kb+8t..kb+8t+7.  The plan puts the weights of the same channels in the
// same lanes.  Every loop is warp-uniform, as mma.sync needs.
template <int kMode = R_EXACT2>
__device__ void op_pw_mma(const Op& op, const int8_t* src, int8_t* dst) {
  const int iw = op[F_IW], ic = op[F_IC];
  const int ow = op[F_OW], oc = op[F_OC], np = op[F_OH] * ow;
  const int sr = op[F_SR], sc = op[F_SC], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int units = (ic + 31) >> 5;
  const int chunks = (np + 8 * NT - 1) / (8 * NT);
  const int4* frag = op.at<int4>(F_W) + lane;
  const int* d = op.at<int>(F_D);
  const float* b0 = op.at<float>(F_BIAS);
  const float* c1 = op.at<float>(F_C1);
  const Div16 by_chunks(chunks), by_ow(ow);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  for (int item = threadIdx.x >> 5; item < (oc >> 4) * chunks; item += kThreads / 32) {
    const int m = by_chunks(item), n0 = (item - m * chunks) * (8 * NT);
    const int r0 = 16 * m + g;  // this lane's output channels: r0 and r0 + 8
    int off[NT];  // input row offset of pixel n0 + 8j + g; -1 past the end
    int acc[NT][4];
    const int d0 = __ldg(d + r0), d1 = __ldg(d + r0 + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = n0 + 8 * j + g, row = by_ow(p);
      off[j] = p < np ? (row * sr * iw + (p - row * ow) * sc) * ic : -1;
      acc[j][0] = acc[j][1] = d0;
      acc[j][2] = acc[j][3] = d1;
    }
    // Every tile's B words are read before the MMAs, and the MMAs go tile
    // after tile, so the reads overlap and so do the MMA chains.  A tile
    // past the pixels reads zeros (off < 0) and its MMAs change nothing
    // that is stored.
    const int4* a = frag + m * units * 32;
    for (int kb = 0; kb < ic; kb += 64) {
      if (ic - kb > 32) {
        const int4 a0 = __ldg(a), a1 = __ldg(a + 32);
        a += 64;
        uint32_t w[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) row_words<4>(src, off[j], kb + 16 * t, ic, w[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[j], a0, w[j][0], w[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[j], a1, w[j][2], w[j][3]);
      } else {
        const int4 a0 = __ldg(a);
        a += 32;
        uint32_t w[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) row_words<2>(src, off[j], kb + 8 * t, ic, w[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[j], a0, w[j][0], w[j][1]);
      }
    }
    const float b0g = __ldg(b0 + r0), b0h = __ldg(b0 + r0 + 8);
    const float c1g = __ldg(c1 + r0), c1h = __ldg(c1 + r0 + 8);
    if constexpr (kMode == R_FIXED)
      store_tiles<R_FIXED>(acc, dst, n0 + 2 * t, np, oc, r0, b0g, b0h, c1g, c1h, fx.lo, fx.hi,
                           fx.zp);
    else if constexpr (kMode != R_EXACT2)
      store_tiles<kMode>(acc, dst, n0 + 2 * t, np, oc, r0, b0g, b0h, c1g, c1h, lo, hi, 0);
    else if (exact)
      store_tiles<R_EXACT>(acc, dst, n0 + 2 * t, np, oc, r0, b0g, b0h, c1g, c1h, lo, hi, 0);
    else store_tiles<R_EXACT2>(acc, dst, n0 + 2 * t, np, oc, r0, b0g, b0h, c1g, c1h, lo, hi, 0);
  }
}

// A 3x3 depthwise op's constants for channel group g (channels 4g..4g+3),
// loaded once per op: w[dh][j] = channel 4g+j's taps (dh, 0), (dh, 1),
// (dh, 2) as one word, low byte first, high byte 0 (the plan's [3][C]
// words); d = -in_zp * the sum of all nine taps; the F_BIAS and F_C1 words
// (bias0 and c1, or bias_q and m).
struct Dw3Consts {
  int w[3][4], d[4];
  float b0[4], c1[4];
  __device__ Dw3Consts(const Op& op, int g, int groups) {
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int4 v = __ldg(op.at<int4>(F_W) + dh * groups + g);
      w[dh][0] = v.x, w[dh][1] = v.y, w[dh][2] = v.z, w[dh][3] = v.w;
    }
    const int4 dv = __ldg(op.at<int4>(F_D) + g);
    const float4 bv = __ldg(op.at<float4>(F_BIAS) + g), cv = __ldg(op.at<float4>(F_C1) + g);
    d[0] = dv.x, d[1] = dv.y, d[2] = dv.z, d[3] = dv.w;
    b0[0] = bv.x, b0[1] = bv.y, b0[2] = bv.z, b0[3] = bv.w;
    c1[0] = cv.x, c1[1] = cv.y, c1[2] = cv.z, c1[3] = cv.w;
  }
};

// A strip's epilogue: output pixel o of the strip (o < n) is the word of
// channels 4g..4g+3 at dst + o * c; the epilogue is chosen once per item.
template <int kMode, int S>
__device__ __forceinline__ void store_strip(const int (&acc)[S][4], int8_t* dst, int n, int c,
                                            const Dw3Consts& k, float lo, float hi, int zp) {
#pragma unroll
  for (int o = 0; o < S; ++o) {
    if (o < n) {
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= (uint32_t)(uint8_t)epilogue<kMode>(acc[o][j], k.b0[j], k.c1[j], lo, hi, zp)
                  << (8 * j);
      *reinterpret_cast<uint32_t*>(dst + o * c) = packed;
    }
  }
}

// 3x3 depthwise conv at stride SD (1 or 2) over C = IC = OC channels, C a
// multiple of 4 whose groups of 4 divide the block (F_DW3 = DW3_S1,
// DW3_S2).  A work item is the thread's group of four channels (fixed for
// the op, so its constants stay in registers) by a strip of DW_STRIP
// adjacent output pixels of one row; items go channel group fastest, so
// the lanes of a warp read neighbouring words, and the odd strip length
// puts the strips of one row on distinct banks.  Per row of the window the
// strip reads NX words (the four channels of one input pixel; a word
// outside the input is in_zp, which d removes again, as in op_dw_vec),
// transposes each pair of columns into one half-word per channel, and
// joins neighbouring pairs into a word of four consecutive columns per
// channel.  At stride 1 the word of columns q..q+3 serves output q with the
// taps (w0, w1, w2, 0) and output q + 1 with (0, w0, w1, w2); at stride 2
// word i serves output i.  The sums are op_dw_vec's, so are the bits.
template <int SD, int kMode = R_EXACT2>
__device__ void op_dw3(const Op& op, const int8_t* src, int8_t* dst) {
  constexpr int S = DW_STRIP;
  constexpr int NX = SD == 1 ? S + 2 : 2 * S + 1;  // input columns of a strip
  constexpr int NP = (NX + 1) / 2;                 // their pairs
  const int ih = op[F_IH], iw = op[F_IW], c = op[F_OC], oh = op[F_OH], ow = op[F_OW];
  const int pt = op[F_PT], pl = op[F_PL], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const uint32_t zpw = __byte_perm((uint32_t)op[F_ZP], 0, 0x0000);
  const int groups = c >> 2, g = threadIdx.x % groups;
  const Dw3Consts k(op, g, groups);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  const int ns = (ow + S - 1) / S;  // strips a row
  const Div16 by_ns(ns);
  const int8_t* sg = src + 4 * g;
  for (int it = threadIdx.x / groups; it < oh * ns; it += kThreads / groups) {
    const int oy = by_ns(it), ox = (it - oy * ns) * S;
    const int r0 = oy * SD - pt, q0 = ox * SD - pl;
    unsigned cols = 0;  // bit i: input column q0 + i lies inside the row
#pragma unroll
    for (int i = 0; i < NX; ++i) cols |= (unsigned)((unsigned)(q0 + i) < (unsigned)iw) << i;
    int acc[S][4];
#pragma unroll
    for (int o = 0; o < S; ++o)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][j] = k.d[j];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int r = r0 + dh;
      const unsigned ok = (unsigned)r < (unsigned)ih ? cols : 0u;
      const int off = (r * iw + q0) * c;
      uint32_t x[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
        x[i] = (ok >> i) & 1u ? *reinterpret_cast<const uint32_t*>(sg + off + i * c) : zpw;
      // pair i: channels (0, 1) and (2, 3) of columns 2i, 2i+1; a last
      // column alone is paired with itself (its partner's tap weight is 0)
      uint32_t p01[NP], p23[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const uint32_t b = x[2 * i + 1 < NX ? 2 * i + 1 : 2 * i];
        p01[i] = __byte_perm(x[2 * i], b, 0x5140);
        p23[i] = __byte_perm(x[2 * i], b, 0x7362);
      }
#pragma unroll
      for (int i = 0; i + 1 < NP; ++i) {
        // channel j's columns 2i..2i+3
        const uint32_t xw[4] = {
            __byte_perm(p01[i], p01[i + 1], 0x5410), __byte_perm(p01[i], p01[i + 1], 0x7632),
            __byte_perm(p23[i], p23[i + 1], 0x5410), __byte_perm(p23[i], p23[i + 1], 0x7632)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (SD == 1) {
            if (2 * i < S) acc[2 * i][j] = __dp4a((int)xw[j], k.w[dh][j], acc[2 * i][j]);
            if (2 * i + 1 < S)
              acc[2 * i + 1][j] =
                  __dp4a((int)xw[j], (int)((unsigned)k.w[dh][j] << 8), acc[2 * i + 1][j]);
          } else if (i < S) {
            acc[i][j] = __dp4a((int)xw[j], k.w[dh][j], acc[i][j]);
          }
        }
      }
    }
    int8_t* out = dst + (oy * ow + ox) * c + 4 * g;
    if constexpr (kMode == R_FIXED)
      store_strip<R_FIXED>(acc, out, ow - ox, c, k, fx.lo, fx.hi, fx.zp);
    else if constexpr (kMode != R_EXACT2) store_strip<kMode>(acc, out, ow - ox, c, k, lo, hi, 0);
    else if (exact) store_strip<R_EXACT>(acc, out, ow - ox, c, k, lo, hi, 0);
    else store_strip<R_EXACT2>(acc, out, ow - ox, c, k, lo, hi, 0);
  }
}

// The 3x3 stride-2 depth-multiplier stem: one input channel broadcast to C
// = OC output channels (F_DW3 = DW3_STEM; the plan takes it where the left
// padding is 1 and the input row a multiple of 4 bytes).  A work item is
// the thread's group of four channels by STEM_STRIP output pixels 4s..4s+3
// of one row, whose windows cover bytes 8s-1 .. 8s+7 of each input row:
// three aligned words (8s-4.., 8s.., 8s+4..; a word outside the input is
// in_zp).  Every channel reads the same byte, so the word of output 4s+j's
// columns, bytes 8s-1+2j .. 8s+2+2j (the last, of weight 0, any byte),
// is one byte permutation and no transpose, and serves four __dp4a.
template <int kMode = R_EXACT2>
__device__ void op_dw3_stem(const Op& op, const int8_t* src, int8_t* dst) {
  constexpr int S = STEM_STRIP;
  const int ih = op[F_IH], iw = op[F_IW], c = op[F_OC], oh = op[F_OH], ow = op[F_OW];
  const int pt = op[F_PT], exact = op[F_EXACT];
  const float lo = (float)op[F_LO], hi = (float)op[F_HI];
  const uint32_t zpw = __byte_perm((uint32_t)op[F_ZP], 0, 0x0000);
  const int groups = c >> 2, g = threadIdx.x % groups;
  const Dw3Consts k(op, g, groups);
  const Fixed fx = kMode == R_FIXED ? Fixed(op) : Fixed();
  const int ns = (ow + S - 1) / S;
  const Div16 by_ns(ns);
  for (int it = threadIdx.x / groups; it < oh * ns; it += kThreads / groups) {
    const int oy = by_ns(it), ox = (it - oy * ns) * S;
    const int r0 = 2 * oy - pt, b = 2 * ox - 4;
    unsigned cols = 0;  // bit m: word m, columns b+4m .. b+4m+3, lies inside the row
#pragma unroll
    for (int m = 0; m < 3; ++m) cols |= (unsigned)((unsigned)(b + 4 * m) < (unsigned)iw) << m;
    int acc[S][4];
#pragma unroll
    for (int o = 0; o < S; ++o)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][j] = k.d[j];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int r = r0 + dh;
      const unsigned ok = (unsigned)r < (unsigned)ih ? cols : 0u;
      const int off = r * iw + b;
      uint32_t w[3];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        w[m] = (ok >> m) & 1u ? *reinterpret_cast<const uint32_t*>(src + off + 4 * m) : zpw;
      const uint32_t xw[S] = {__byte_perm(w[0], w[1], 0x6543), __byte_perm(w[1], w[2], 0x4321),
                              __byte_perm(w[1], w[2], 0x6543), w[2] >> 8};
#pragma unroll
      for (int o = 0; o < S; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[o][j] = __dp4a((int)xw[o], k.w[dh][j], acc[o][j]);
    }
    int8_t* out = dst + (oy * ow + ox) * c + 4 * g;
    if constexpr (kMode == R_FIXED)
      store_strip<R_FIXED>(acc, out, ow - ox, c, k, fx.lo, fx.hi, fx.zp);
    else if constexpr (kMode != R_EXACT2) store_strip<kMode>(acc, out, ow - ox, c, k, lo, hi, 0);
    else if (exact) store_strip<R_EXACT>(acc, out, ow - ox, c, k, lo, hi, 0);
    else store_strip<R_EXACT2>(acc, out, ow - ox, c, k, lo, hi, 0);
  }
}

// AveragePool: in-bounds sum (true zeros outside), then
// roundf(c0 * (recip[p] * f32(sum)) + c1), clamped; under R_RAW the sum's
// low byte (every other mode keeps this epilogue).
template <int kMode = R_EXACT2>
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
    if constexpr (kMode == R_RAW) {
      dst[e] = (int8_t)s;
    } else {
      const float t = __fmul_rn(__ldg(recip + p), __int2float_rn(s));
      dst[e] = mf_round_away(__fadd_rn(__fmul_rn(c0, t), c1), lo, hi);
    }
  }
}

// The persistent block loop: block b takes samples b, b + gridDim.x, ...;
// stages the input row in buffer B, runs op o (descriptor o of the plan)
// from one buffer into the other, A when o is even, and writes the last
// tensor out.  run_op(op, src, dst) runs one op.
template <typename RunOp>
__device__ __forceinline__ void run_plan(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                         long long B, const unsigned char* __restrict__ plan,
                                         int n_ops, int in_elems, int out_elems, int smem_a,
                                         RunOp run_op) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf_a = reinterpret_cast<int8_t*>(smem);
  int8_t* buf_b = reinterpret_cast<int8_t*>(smem + smem_a);
  const int* desc = reinterpret_cast<const int*>(plan);
  const bool vec_in = (in_elems & 15) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_out = (out_elems & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const int8_t* xr = x + b * in_elems;
    if (vec_in) {
      for (int i = threadIdx.x; i < (in_elems >> 4); i += kThreads)
        reinterpret_cast<int4*>(buf_b)[i] = __ldg(reinterpret_cast<const int4*>(xr) + i);
    } else {
      for (int i = threadIdx.x; i < in_elems; i += kThreads) buf_b[i] = __ldg(xr + i);
    }
    __syncthreads();
    const int8_t* src = buf_b;
    for (int o = 0; o < n_ops; ++o) {
      int8_t* dst = (o & 1) ? buf_b : buf_a;
      run_op(Op{desc + o * NF, plan}, src, dst);
      __syncthreads();
      src = dst;
    }
    int8_t* orow = out + b * out_elems;
    if (vec_out) {
      for (int i = threadIdx.x; i < (out_elems >> 4); i += kThreads)
        reinterpret_cast<int4*>(orow)[i] = reinterpret_cast<const int4*>(src)[i];
    } else {
      for (int i = threadIdx.x; i < out_elems; i += kThreads) orow[i] = src[i];
    }
    __syncthreads();  // the next sample's input overwrites buffer B
  }
}

// What the shared paths' reads assume of an op, checked by an entry point
// on the host copy f of its descriptor before the launch (k_dw, k_pw: the
// caller's kinds of a depthwise and a 1x1 conv): the kind, window, stride
// and channel multiples the plan marked it for, a tensor of at most
// MAX_LANES elements (F_MMA, F_DW3), and 16-byte aligned constants for the
// vector loads.  True for an op on none of the shared paths.
inline bool shared_path_ok(const int* f, int k_dw, int k_pw) {
  const int kind = f[F_KIND], c = f[F_OC], ic = f[F_IC], n_out = f[F_OUT];
  const int path = f[F_DW3], vec = f[F_VEC], mma = f[F_MMA];
  if (!path && !vec && !mma) return true;
  if (f[F_W] % 16 || f[F_D] % 16 || f[F_BIAS] % 16 || f[F_C1] % 16) return false;
  if (mma) return kind == k_pw && c % 16 == 0 && n_out <= MAX_LANES && !path && !vec;
  const bool groups = c > 0 && c % 4 == 0 && kThreads % (c / 4) == 0;
  if (kind != k_dw || !groups || (path && vec)) return false;
  if (vec) return ic == 1 || ic == c;
  const int s = f[F_SR];
  if (n_out > MAX_LANES || f[F_KH] != 3 || f[F_KW] != 3 || f[F_SC] != s) return false;
  if (path == DW3_S1 || path == DW3_S2) return ic == c && s == (path == DW3_S1 ? 1 : 2);
  return path == DW3_STEM && ic == 1 && s == 2 && f[F_PL] == 1 && f[F_IW] % 4 == 0;
}

// Launch a kernel built on run_plan: as many persistent blocks as fit the
// card at smem_a + smem_b bytes of shared memory, at most one a sample.
// Returns the CUDA error code (0 on success); a launch the card refuses,
// for too much shared memory for example, returns its error here.
template <typename Kernel>
int launch_plan(Kernel kernel, const void* x, void* out, long long B, const void* plan,
                int n_ops, int in_elems, int out_elems, int smem_a, int smem_b, void* stream) {
  const int smem = smem_a + smem_b;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = B < (long long)per_sm * sms ? B : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), B,
      static_cast<const unsigned char*>(plan), n_ops, in_elems, out_elems, smem_a);
  return (int)cudaGetLastError();
}

}  // namespace
