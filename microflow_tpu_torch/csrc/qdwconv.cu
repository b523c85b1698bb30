// Fused int8 depthwise conv + requantization + activation for Hopper (sm_90a).
//
// Replaces the Pallas kernel microflow_tpu/kernels/qdwconv.py::qdwconv
// (body _qdwconv_kernel).  It reads the unpadded NHWC input and puts the
// input zero point in place of every tap outside it; the weights arrive
// centred (w - w_zp[c], i32), so
//
//   q[b,i,j,c] = sum_mn x_zp[b, sr*i+m-top, sc*j+n-left, c] * wc[m,n,c] + d[c]
//   y          = roundf(bias0[c] + c1[c] * f32(q))          (f32 mul, then add)
//   out        = clip(y, lo, hi) as int8                    (activation folded in)
//
// with d[c] = -in_zp * sum_mn wc[m,n,c], which removes the zero point again.
// The input has C channels or one (the depth-multiplier stem: every output
// channel reads channel 0).
//
// What bounds it on an H100: bytes.  There is no contraction over channels:
// each output costs KH*KW multiply-adds against about one input byte and one
// output byte.  person_detect's 14 depthwise layers read 149,760 input bytes
// and write 107,136 a sample: at batch 8192, 2.10 GB, 0.628 ms at 3.35 TB/s.
// Close behind comes instruction issue: 878M outputs at that batch, each with
// two conversions on the SM's 16-a-clock pipe (~0.42 ms).
//
// The design (qdwconv_tile): the 3x3 convs at stride 1 or 2 over a multiple
// of 4 channels, and the 3x3 stride-2 stem, whose centred weights fit int8.
// A block takes a band of output rows of one sample, or of several samples
// when a sample is small, and stages the input rows of the band with their
// halo in shared memory: 16-byte cp.async copies from the unpadded rows
// where they are aligned, in_zp words in the halo, so every input byte
// leaves device memory about once and no padded copy is ever written.  A
// thread keeps one group of four channels, its nine taps as __dp4a words
// and its epilogue constants in registers, and takes strips of adjacent
// output pixels of one row: each shared-memory word it reads serves every
// output of the strip whose window holds it (the taps as in
// flatpack.cu::op_dw3 and op_dw3_stem), and the four results of a pixel
// go out as one word.  Index arithmetic is 32-bit within a sample, with
// multiply-high division by constants.  The tile's shape (rows, samples,
// staged row pitch) is planned on the host, kernels/qdwconv.py::plan.
//
// Every other shape (speech's 10x8 stem, C % 4 != 0, other windows, weights
// that do not fit int8) takes qdwconv_general: one output pixel (four
// channels, or one) a thread, each tap tested against the input's bounds.
//
// Rounding and casts as in the other kernels (epilogue.cuh): -fmad=false and
// __fmul_rn/__fadd_rn keep the multiply and the add apart; roundf rounds half
// away from zero; the clamp comes before the conversion.

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 48 * 1024;  // shared-memory bytes a block (no opt-in needed)
enum { PATH_GENERAL, PATH_S1, PATH_S2, PATH_STEM };

// n / d for 0 <= n < 2^16 by a multiply-high (d >= 1).
struct Div16 {
  unsigned lo;
  bool one;
  __device__ explicit Div16(int d) : lo(0xffffffffu / (unsigned)d + 1u), one(d == 1) {}
  __device__ int operator()(int n) const {
    return one ? n : (int)__umulhi((unsigned)n, lo);
  }
};

// One launch's geometry and tile plan (tile fields unused by the general path).
struct Geo {
  int B, H, W, cin, C, kh, kw, sr, sc, pt, pl, oh, ow;
  int rows;     // output rows a band
  int samples;  // samples a block
  int nr;       // staged input rows a sample: (rows - 1) * sr + 3
  int margin;   // bytes before input column 0 in a staged row (a multiple of 16)
  int pitch;    // bytes a staged row (a multiple of 16)
  int bands;    // bands a sample: ceil(oh / rows)
  int zp;
  float lo, hi;
};

__device__ __forceinline__ uint32_t splat(int zp) { return (uint32_t)(zp & 0xff) * 0x01010101u; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Stages the tile: for sample k < samples and staged row i < nr (input row
// r0 + i of sample b0 + k), pitch bytes whose byte margin + o holds byte o of
// the input row (0 <= o < W * cin) and in_zp everywhere else (the halo left
// and right, rows above and below the input, samples past B).  VEC = 16 or
// 4: the row's bytes are copied in units of VEC bytes (the rows and the
// input are VEC-aligned, so a unit is all input or all halo); VEC = 1: each
// 4-byte word is put together byte by byte.  Every shared byte is written
// once; the caller waits for the cp.async copies (cp.async.wait_all).
template <int VEC>
__device__ void stage(int8_t* tile, const int8_t* __restrict__ x, const Geo& g, int b0, int r0) {
  constexpr int U = VEC == 16 ? 16 : 4;
  const int row_bytes = g.W * g.cin, units = g.pitch / U, total = g.samples * g.nr * units;
  const Div16 by_units(units), by_nr(g.nr);
  const uint32_t zpw = splat(g.zp);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int sr = by_units(i), k = by_nr(sr);  // sr = k * nr + staged row
    const int r = r0 + sr - k * g.nr, b = b0 + k, o = (i - sr * units) * U - g.margin;
    const bool row_in = b < g.B && (unsigned)r < (unsigned)g.H;
    int8_t* dst = tile + i * U;
    const int8_t* src = x + ((long long)b * g.H + r) * row_bytes;  // dereferenced only if row_in
    if (VEC == 16) {
      if (row_in && o >= 0 && o < row_bytes) cp_async16(dst, src + o);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(zpw, zpw, zpw, zpw);
    } else if (VEC == 4) {
      if (row_in && o >= 0 && o < row_bytes) cp_async4(dst, src + o);
      else *reinterpret_cast<uint32_t*>(dst) = zpw;
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int oe = o + e;
        const int v = row_in && (unsigned)oe < (unsigned)row_bytes ? src[oe] : g.zp;
        w |= (uint32_t)(v & 0xff) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(dst) = w;
    }
  }
}

// A thread's channel group (channels c..c+3): w[dh][j] = channel c+j's taps
// (dh, 0), (dh, 1), (dh, 2) as the low three bytes of one word, high byte 0
// (the centred weights fit int8: the host says so); d, bias0, c1.
struct Consts {
  int w[3][4], d[4];
  float b0[4], c1[4];
  __device__ Consts(const int32_t* __restrict__ wc, const int32_t* __restrict__ dd,
                    const float* __restrict__ bias0, const float* __restrict__ c1v, int C, int c) {
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int4 t0 = __ldg(reinterpret_cast<const int4*>(wc + (dh * 3 + 0) * C + c));
      const int4 t1 = __ldg(reinterpret_cast<const int4*>(wc + (dh * 3 + 1) * C + c));
      const int4 t2 = __ldg(reinterpret_cast<const int4*>(wc + (dh * 3 + 2) * C + c));
      const auto tap = [](int a, int b, int e) {
        return (int)((uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(e & 0xff) << 16);
      };
      w[dh][0] = tap(t0.x, t1.x, t2.x), w[dh][1] = tap(t0.y, t1.y, t2.y);
      w[dh][2] = tap(t0.z, t1.z, t2.z), w[dh][3] = tap(t0.w, t1.w, t2.w);
    }
    const int4 dv = __ldg(reinterpret_cast<const int4*>(dd + c));
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias0 + c));
    const float4 cv = __ldg(reinterpret_cast<const float4*>(c1v + c));
    d[0] = dv.x, d[1] = dv.y, d[2] = dv.z, d[3] = dv.w;
    b0[0] = bv.x, b0[1] = bv.y, b0[2] = bv.z, b0[3] = bv.w;
    c1[0] = cv.x, c1[1] = cv.y, c1[2] = cv.z, c1[3] = cv.w;
  }
};

// A strip's epilogue: output pixel o of the strip (o < n) is the word of the
// group's four channels at dst + o * C.
template <int S>
__device__ __forceinline__ void store_strip(const int (&acc)[S][4], int8_t* dst, int n, int C,
                                            const Consts& k, float lo, float hi) {
#pragma unroll
  for (int o = 0; o < S; ++o) {
    if (o < n) {
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= (uint32_t)(uint8_t)mf_round_away(mf_affine(k.b0[j], k.c1[j], acc[o][j]), lo, hi)
                  << (8 * j);
      *reinterpret_cast<uint32_t*>(dst + o * C) = packed;
    }
  }
}

// The tile's work items: item it = (k * rows + output row in the band) * ns
// + strip; thread t keeps channel group t % G and takes items t / G,
// + blockDim / G, ...  Calls f(k, oy_local, ox) for each item inside the
// output (sample b0 + k < B, output row oy0 + oy_local < OH).
template <typename F>
__device__ __forceinline__ void for_items(const Geo& g, int S, int b0, int oy0, F&& f) {
  const int G = g.C >> 2, ns = (g.ow + S - 1) / S, per = g.rows * ns;
  const Div16 by_ns(ns), by_per(per);
  for (int it = threadIdx.x / G; it < g.samples * per; it += blockDim.x / G) {
    const int k = by_per(it), rem = it - k * per, oyl = by_ns(rem);
    if (b0 + k < g.B && oy0 + oyl < g.oh) f(k, oyl, (rem - oyl * ns) * S);
  }
}

// 3x3 at stride SD over C = cin channels: a strip of 3 output pixels reads NX
// words (the group's channels of one input column) a window row, transposes
// each pair of columns into one half-word a channel and joins neighbouring
// pairs into a word of four consecutive columns a channel.  At stride 1 the
// word of columns q..q+3 serves output q with the taps (w0, w1, w2, 0) and
// output q + 1 with (0, w0, w1, w2); at stride 2 word i serves output i.
template <int SD>
__device__ __forceinline__ void dw3_rows(const int8_t* tile, int8_t* __restrict__ out,
                                         const Geo& g, const Consts& k, int c, int b0, int oy0) {
  constexpr int S = 3, NX = SD == 1 ? S + 2 : 2 * S + 1, NP = (NX + 1) / 2;
  const int C = g.C;
  const int8_t* tg = tile + g.margin - g.pl * C + c;  // input column 0 - pl, the group's bytes
  for_items(g, S, b0, oy0, [&](int kk, int oyl, int ox) {
    const int8_t* p = tg + (kk * g.nr + oyl * SD) * g.pitch + ox * SD * C;
    int acc[S][4];
#pragma unroll
    for (int o = 0; o < S; ++o)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][j] = k.d[j];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      uint32_t x[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
        x[i] = *reinterpret_cast<const uint32_t*>(p + dh * g.pitch + i * C);
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
    const int b = b0 + kk, oy = oy0 + oyl;
    int8_t* dst = out + (long long)b * g.oh * g.ow * C + (oy * g.ow + ox) * C + c;
    store_strip<S>(acc, dst, g.ow - ox, C, k, g.lo, g.hi);
  });
}

// The 3x3 stride-2 stem (cin = 1, left padding 1): a strip of 4 output
// pixels 4s..4s+3 covers bytes 8s-1 .. 8s+7 of each staged row, three
// aligned words (8s-4.., 8s.., 8s+4..).  Every channel reads the same byte,
// so the word of output 4s+j's columns, bytes 8s-1+2j .. 8s+2+2j (the last,
// of weight 0, any byte), is one byte permutation and serves four __dp4a.
__device__ __forceinline__ void dw3_stem(const int8_t* tile, int8_t* __restrict__ out,
                                         const Geo& g, const Consts& k, int c, int b0, int oy0) {
  constexpr int S = 4;
  const int8_t* tg = tile + g.margin - 4;  // margin >= 16: column -4 of a staged row
  for_items(g, S, b0, oy0, [&](int kk, int oyl, int ox) {
    const int8_t* p = tg + (kk * g.nr + oyl * 2) * g.pitch + 2 * ox;
    int acc[S][4];
#pragma unroll
    for (int o = 0; o < S; ++o)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][j] = k.d[j];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      uint32_t w[3];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        w[m] = *reinterpret_cast<const uint32_t*>(p + dh * g.pitch + 4 * m);
      const uint32_t xw[S] = {__byte_perm(w[0], w[1], 0x6543), __byte_perm(w[1], w[2], 0x4321),
                              __byte_perm(w[1], w[2], 0x6543), w[2] >> 8};
#pragma unroll
      for (int o = 0; o < S; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[o][j] = __dp4a((int)xw[o], k.w[dh][j], acc[o][j]);
    }
    const int b = b0 + kk, oy = oy0 + oyl;
    int8_t* dst = out + (long long)b * g.oh * g.ow * g.C + (oy * g.ow + ox) * g.C + c;
    store_strip<S>(acc, dst, g.ow - ox, g.C, k, g.lo, g.hi);
  });
}

// Block = (group of `samples` samples, band of `rows` output rows); blockDim
// = (kThreads / G) * G for G = C / 4 channel groups.
template <int PATH, int VEC>
__global__ void __launch_bounds__(kThreads, 4) qdwconv_tile(
    const int8_t* __restrict__ x, const int32_t* __restrict__ wc, const int32_t* __restrict__ d,
    const float* __restrict__ bias0, const float* __restrict__ c1, int8_t* __restrict__ out,
    const Geo g) {
  extern __shared__ __align__(16) int8_t tile[];
  constexpr int SD = PATH == PATH_S1 ? 1 : 2;
  const int c = 4 * (threadIdx.x % (g.C >> 2));
  const int bg = blockIdx.x / g.bands, band = blockIdx.x - bg * g.bands;
  const int b0 = bg * g.samples, oy0 = band * g.rows;
  stage<VEC>(tile, x, g, b0, oy0 * SD - g.pt);
  // the constants load while the copies fly, after the byte-wise staging
  // (whose registers they would otherwise share)
  const Consts k(wc, d, bias0, c1, g.C, c);
  if (VEC != 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if constexpr (PATH == PATH_STEM) dw3_stem(tile, out, g, k, c, b0, oy0);
  else dw3_rows<SD>(tile, out, g, k, c, b0, oy0);
}

// Any shape: one output pixel for V = 4 consecutive channels (C % 4 == 0;
// word loads and stores) or V = 1 a thread.  blockIdx.x = sample * bps +
// block of the sample.
template <int V>
__global__ void __launch_bounds__(kThreads) qdwconv_general(
    const int8_t* __restrict__ x, const int32_t* __restrict__ wc, const int32_t* __restrict__ d,
    const float* __restrict__ bias0, const float* __restrict__ c1, int8_t* __restrict__ out,
    const Geo g, int bps) {
  const int b = blockIdx.x / bps;
  const int e = (blockIdx.x - b * bps) * kThreads + threadIdx.x;  // within the sample
  const int cv = g.C / V;
  if (e >= g.oh * g.ow * cv) return;
  const int c = (e % cv) * V, p = e / cv, j = p % g.ow, i = p / g.ow;
  const int8_t* xb = x + (long long)b * g.H * g.W * g.cin;
  const int ci = g.cin == 1 ? 0 : c;
  int acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0;
  for (int m = 0; m < g.kh; ++m) {
    const int r = i * g.sr - g.pt + m;
    const bool row_in = (unsigned)r < (unsigned)g.H;
    for (int n = 0; n < g.kw; ++n) {
      const int q = j * g.sc - g.pl + n;
      const bool in = row_in && (unsigned)q < (unsigned)g.W;
      const int off = (r * g.W + q) * g.cin + ci;  // read only if in
      const int32_t* wt = wc + (m * g.kw + n) * g.C + c;
      if constexpr (V == 4) {
        char4 xv = make_char4(g.zp, g.zp, g.zp, g.zp);
        if (in) {
          if (g.cin == 1) {
            const signed char v = __ldg(xb + off);
            xv = make_char4(v, v, v, v);
          } else {
            xv = __ldg(reinterpret_cast<const char4*>(xb + off));
          }
        }
        const int4 wv = __ldg(reinterpret_cast<const int4*>(wt));
        acc[0] += (int)xv.x * wv.x;
        acc[1] += (int)xv.y * wv.y;
        acc[2] += (int)xv.z * wv.z;
        acc[3] += (int)xv.w * wv.w;
      } else {
        acc[0] += (in ? (int)__ldg(xb + off) : g.zp) * __ldg(wt);
      }
    }
  }
  int8_t* o = out + (long long)b * g.oh * g.ow * g.C + p * g.C + c;
  if constexpr (V == 4) {
    uint32_t packed = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int8_t r = mf_round_away(
          mf_affine(__ldg(bias0 + c + v), __ldg(c1 + c + v), acc[v] + __ldg(d + c + v)), g.lo,
          g.hi);
      packed |= (uint32_t)(uint8_t)r << (8 * v);
    }
    *reinterpret_cast<uint32_t*>(o) = packed;
  } else {
    o[0] = mf_round_away(mf_affine(__ldg(bias0 + c), __ldg(c1 + c), acc[0] + __ldg(d + c)), g.lo,
                         g.hi);
  }
}

template <int PATH>
int launch_tile(int vec, const int8_t* x, const int32_t* w, const int32_t* d, const float* b,
                const float* c, int8_t* o, const Geo& g, unsigned blocks, int threads, int smem,
                cudaStream_t s) {
  switch (vec) {
    case 16: qdwconv_tile<PATH, 16><<<blocks, threads, smem, s>>>(x, w, d, b, c, o, g); break;
    case 4: qdwconv_tile<PATH, 4><<<blocks, threads, smem, s>>>(x, w, d, b, c, o, g); break;
    case 1: qdwconv_tile<PATH, 1><<<blocks, threads, smem, s>>>(x, w, d, b, c, o, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* p, unsigned n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch, 0 on success, cudaErrorInvalidValue for arguments the chosen
// path cannot take.  path: PATH_GENERAL (vec = channels a thread, 4 or 1)
// or a tile path (vec = bytes a staging unit: 16, 4, or 1 for words put
// together byte by byte; rows, samples, margin, pitch: the tile plan of
// kernels/qdwconv.py::plan).
extern "C" int mf_qdwconv(const void* x, const void* wc, const void* d, const void* bias0,
                          const void* c1, void* out, int B, int H, int W, int cin, int C, int KH,
                          int KW, int SR, int SC, int PT, int PL, int OH, int OW, int zp, float lo,
                          float hi, int path, int vec, int rows, int samples, int margin,
                          int pitch, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || OH <= 0 || OW <= 0 || KH <= 0 || KW <= 0 ||
      SR <= 0 || SC <= 0 || PT < 0 || PL < 0 || PT >= KH || PL >= KW || (cin != C && cin != 1) ||
      zp < -128 || zp > 127)
    return (int)cudaErrorInvalidValue;
  if ((long long)H * W * cin >= (1LL << 31) || (long long)OH * OW * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const int8_t*>(x);
  const auto* w = static_cast<const int32_t*>(wc);
  const auto* dd = static_cast<const int32_t*>(d);
  const auto* bb = static_cast<const float*>(bias0);
  const auto* cc = static_cast<const float*>(c1);
  auto* o = static_cast<int8_t*>(out);
  Geo g{B, H, W, cin, C, KH, KW, SR, SC, PT, PL, OH, OW, 0, 0, 0, 0, 0, 0, zp, lo, hi};
  if (path == PATH_GENERAL) {
    if (vec == 4 && (C % 4 || !aligned(o, 4) || !aligned(w, 16) || (cin == C && !aligned(xx, 4))))
      return (int)cudaErrorInvalidValue;
    if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
    const int bps = (int)(((long long)OH * OW * (C / vec) + kThreads - 1) / kThreads);
    if ((long long)bps * B >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(bps * B);
    if (vec == 4) qdwconv_general<4><<<blocks, kThreads, 0, s>>>(xx, w, dd, bb, cc, o, g, bps);
    else qdwconv_general<1><<<blocks, kThreads, 0, s>>>(xx, w, dd, bb, cc, o, g, bps);
    return (int)cudaGetLastError();
  }
  // a tile path: check every assumption its reads make
  if (path != PATH_S1 && path != PATH_S2 && path != PATH_STEM) return (int)cudaErrorInvalidValue;
  const int sd = path == PATH_S1 ? 1 : 2, S = path == PATH_STEM ? 4 : 3, G = C / 4;
  const int row_bytes = W * cin, ns = (OW + S - 1) / S;
  if (KH != 3 || KW != 3 || SR != sd || SC != sd || C % 4 || G > kThreads || rows <= 0 ||
      samples <= 0 || margin % 16 || pitch % 16 || margin + row_bytes > pitch ||
      !aligned(o, 4) || !aligned(w, 16) || !aligned(dd, 16) || !aligned(bb, 16) ||
      !aligned(cc, 16) || (vec != 16 && vec != 4 && vec != 1) ||
      (vec > 1 && (row_bytes % vec || !aligned(xx, vec))))
    return (int)cudaErrorInvalidValue;
  if (path == PATH_STEM ? (cin != 1 || PL != 1 || margin < 4 || margin + 8 * ns > pitch)
                        : (cin != C || margin < PL * C ||
                           margin + ((ns - 1) * S * sd + (sd == 1 ? S + 2 : 2 * S + 1) - PL) * C >
                               pitch))
    return (int)cudaErrorInvalidValue;
  g.rows = rows, g.samples = samples, g.nr = (rows - 1) * sd + 3, g.margin = margin;
  g.pitch = pitch, g.bands = (OH + rows - 1) / rows;
  const long long smem = (long long)samples * g.nr * pitch;
  const long long blocks = (long long)((B + samples - 1) / samples) * g.bands;
  if (smem > kMaxTile || blocks >= (1LL << 31) || samples * rows * ns >= (1 << 16))
    return (int)cudaErrorInvalidValue;
  const int threads = (kThreads / G) * G;
  switch (path) {
    case PATH_S1:
      return launch_tile<PATH_S1>(vec, xx, w, dd, bb, cc, o, g, (unsigned)blocks, threads,
                                  (int)smem, s);
    case PATH_S2:
      return launch_tile<PATH_S2>(vec, xx, w, dd, bb, cc, o, g, (unsigned)blocks, threads,
                                  (int)smem, s);
    default:
      return launch_tile<PATH_STEM>(vec, xx, w, dd, bb, cc, o, g, (unsigned)blocks, threads,
                                    (int)smem, s);
  }
}
