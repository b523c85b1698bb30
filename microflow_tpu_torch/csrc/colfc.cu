// Column-FC kernel for Hopper (sm_90a): a chain of tiny FullyConnected
// layers, every width <= 32, on the int8 tensor cores.
//
// Replaces the Pallas kernel microflow_tpu/kernels/colfc.py::build_col_kernel
// (the experimental `colfc` backend; sine is 1 -> 16 -> 16 -> 1).  The TPU
// kernel laid the batch on the vector lanes so that a K <= 32 product did
// not waste a 128-wide matrix unit.  Here the samples go on the M of
// mma.sync m16n8k32 (mma_s8.cuh) and the features on its N:
//
//   acc[s][n] = d[n] + sum_k x[s][k] * W[k][n]       (s32, on the tensor cores)
//   x'[s][n]  = exact2(bias0[n] + c1[n] * f32(acc))   (multiply, then add)
//
// - One mma per 16 samples (an m-tile) and 8 features (an n-tile) of a
//   layer, K zero-padded to 32: sine takes 2 + 2 + 1 an m-tile.  The
//   accumulators start at d = -in_zp * colsum(W), as op_pw_mma's do.
// - Layer l's accumulators become layer l+1's A fragment in registers, with
//   no shared memory.  Lane 4g+t holds C (g, 8j+2t), (g, 8j+2t+1),
//   (g+8, ..) of n-tile j.  After the epilogue, n-tiles 0-1 pack into
//   a.x (row g) and a.y (row g+8), n-tiles 2-3 into a.z and a.w, the odd
//   n-tile's pair in the low half (run_layer).  So A position 4t+i holds
//   feature pi(4t+i) = 2t + i%2 + 8*(i < 2) (+16 in the upper half); the
//   plan permutes layer l+1's rows of W by pi once, at build
//   (kernels/colfc.py::pack_col_plan), with zero rows for features past
//   N_l, so whatever a padded column holds after its epilogue adds nothing
//   (it can be nonzero: a RELU bound lo > 0 lifts it).  Layer 0 reads x in
//   natural order.
// - The epilogue is exact2: y = bias0 + c1 * f32(acc), then
//   trunc(y + (y >= 0 ? 0.5 : -0.5)), clamped.  The sign's 0.5 is
//   copysignf(0.5, y): at y = -0 it picks -0.5 where exact2 picks 0.5, and
//   both truncate to 0 (or clamp to the same bound).  The conversion to
//   int8 saturates (F2IP: two outputs converted and packed in one
//   instruction), which is the clamp wherever the layer's bounds are
//   int8's; tighter bounds clamp t in f32 first (the bounds are integers,
//   so that commutes with the truncation).  f32(acc) is a conversion: a
//   conversion-free form (the accumulators started at d plus the bits of
//   1.5 * 2^23, one f32 subtraction) was slower on an H100
//   (scripts/torch_colfc_sweep.py, PERF.md).
// - Narrow ends: for K0 <= kNarrowIn (sine's 1) lane i of a warp reads
//   sample i of the work item whole and shuffles hand rows g and g + 8 to
//   the lanes that hold them in A; for N_out <= kNarrowOut (sine's 1) the
//   last layer's columns repeat over its n-tile (pack_col_plan), each lane
//   keeps one C register (one epilogue an m-tile, not four), and lane i
//   gathers sample i by shuffles and writes it whole.  Wider ends are read
//   and written by the lanes that hold them: words where K0 % 4 == 0 and x
//   is 4-byte aligned, pairs where N_out is even and out 2-byte aligned,
//   else bytes.
// - A persistent grid: as many blocks as the card keeps resident (SMs x
//   the occupancy the runtime reports, cached per device).  Each block
//   copies the plan (n-tile counts, bounds, B fragments in mma_s8's order,
//   d, bias0, c1: 1.8 KB for sine) into shared memory once; each warp then
//   takes work items of kTilesWarp m-tiles with a grid stride, reloading
//   each layer's B fragments and constants per item.  Rows past B are zero
//   on load and not stored.
//
// What bounds it on an H100: not the bytes (1 in and 1 out a sample for
// sine) nor the tensor cores (5 mma an m-tile), but instruction issue:
// ~7 instructions an epilogue over 17 epilogues a lane an m-tile for
// sine, and the loop around them (PERF.md).  kTilesWarp and kMinBlocks
// were chosen by scripts/torch_colfc_sweep.py.

#include <atomic>

#include "mma_s8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 32;
constexpr int kHeader = 4;     // words a layer: n-tiles, lo and hi (f32 bits), data offset
constexpr int kTilesWarp = 8;  // m-tiles of 16 samples a warp's work item
constexpr int kRowsItem = 16 * kTilesWarp;
constexpr int kRowRegs = (kRowsItem + 31) / 32;  // rows a lane on the narrow paths
constexpr int kMinBlocks = 2;  // blocks an SM (__launch_bounds__)
constexpr int kNarrowIn = 4;   // K0 up to which a lane reads whole rows
constexpr int kNarrowOut = 2;  // N_out up to which a lane writes whole rows
static_assert(kHeader == 4, "a layer's header is one int4");

// f32(acc), exact: every accumulator of a plan is below 2^20 in magnitude.
__device__ __forceinline__ float acc_f32(int acc) { return __int2float_rn(acc); }

// The exact2 epilogue of one accumulator, before the int8 saturation:
// trunc(t), t = y + copysign(0.5, y), y = bias0 + c1 * f32(acc); t
// clamped to [lo, hi] first where the layer's bounds are tighter than
// int8's (kClamp), else the saturation of pack_s8 is the clamp.
template <bool kClamp>
__device__ __forceinline__ int exact2_int(int acc, float b0, float c1, float lo, float hi) {
  const float y = __fadd_rn(b0, __fmul_rn(c1, acc_f32(acc)));
  float t = __fadd_rn(y, copysignf(0.5f, y));
  if (kClamp) t = fminf(fmaxf(t, lo), hi);
  return __float2int_rz(t);
}

// (c << 16) | (sat8(a) << 8) | sat8(b): two outputs saturated to int8 and
// packed below the low half of c.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, uint32_t c) {
  uint32_t d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The A fragment of an m-tile whose lane rows are lr and lr + 8 of a work
// item (xi: its first row; rows: its rows below B): register 2h + s holds
// k = 16h + 4t .. + 3 of row lr + 8s, zero past K0 and past B.  words:
// K0 % 4 == 0 and x 4-byte aligned.
__device__ __forceinline__ void load_a(const int8_t* __restrict__ xi, int lr, int rows, int k0,
                                       int t, bool words, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (16 * h >= k0) break;
    const int k = 16 * h + 4 * t;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int row = lr + 8 * s;
      if (row >= rows || k >= k0) continue;
      const int8_t* p = xi + row * k0 + k;
      if (words) {
        a[2 * h + s] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= k0) break;
          if (k + i < k0) v |= (uint32_t)(uint8_t)__ldg(p + i) << (8 * i);
        }
        a[2 * h + s] = v;
      }
    }
  }
}

// x of K0 <= kNarrowIn: lane i reads rows i, i + 32, .. of the work item
// whole (a word where K0 == 4 and x is 4-byte aligned, else bytes); the
// lanes t == 0 take rows g and g + 8 of each m-tile by shuffles.  Every
// other A byte is a K position from 4 on: zero.
__device__ __forceinline__ void load_narrow(const int8_t* __restrict__ xi, int rows, int k0,
                                            int lane, int g, int t, bool words,
                                            uint32_t (&a)[kTilesWarp][4]) {
  uint32_t v[kRowRegs];
#pragma unroll
  for (int u = 0; u < kRowRegs; ++u) {
    const int row = 32 * u + lane;
    const int8_t* p = xi + row * k0;
    v[u] = 0;
    if (row < rows) {
      if (words) {
        v[u] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
#pragma unroll
        for (int i = 0; i < kNarrowIn; ++i)
          if (i < k0) v[u] |= (uint32_t)(uint8_t)__ldg(p + i) << (8 * i);
      }
    }
  }
  const uint32_t keep = t == 0 ? ~0u : 0u;
#pragma unroll
  for (int m = 0; m < kTilesWarp; ++m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = 16 * m + 8 * s;  // + g: never past the next multiple of 32
      a[m][s] = __shfl_sync(~0u, v[r >> 5], (r & 31) + g) & keep;
    }
    a[m][2] = a[m][3] = 0;
  }
}

// The last layer's outputs of rows lr and lr + 8 of a work item (oi: its
// first row) from the packed fragment: features 8q + 2t and 8q + 2t + 1 of
// row lr + 8s are the high (q even) or low (q odd) half of
// a[2(q>>1) + s].  pairs: N_out even and out 2-byte aligned.
__device__ __forceinline__ void store_rows(int8_t* __restrict__ oi, int lr, int rows, int n_out,
                                           int t, bool pairs, const uint32_t (&a)[4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int row = lr + 8 * s;
    if (row >= rows) continue;
    int8_t* o = oi + row * n_out;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (8 * q >= n_out) break;
      const int c = 8 * q + 2 * t;
      const uint32_t v = a[2 * (q >> 1) + s] >> (q & 1 ? 0 : 16);
      if (pairs) {
        if (c < n_out) *reinterpret_cast<uint16_t*>(o + c) = (uint16_t)v;
      } else {
        if (c < n_out) o[c] = (int8_t)v;
        if (c + 1 < n_out) o[c + 1] = (int8_t)(v >> 8);
      }
    }
  }
}

// The last layer where N_out <= kNarrowOut.  Its one n-tile's 8 columns
// are its N_out columns repeated (pack_col_plan), so C register i of lane
// 4g+t holds row g + 8(i/2) and column (2t + i%2) % N_out: lane t keeps
// register t alone (row g + 8(t/2), column t % N_out) and runs one
// epilogue an m-tile, not four.  q[m]: that output, before the int8
// saturation.
template <bool kClamp>
__device__ __forceinline__ void run_last_narrow(const int* L, float lo, float hi, int lane, int t,
                                                const uint32_t (&a)[kTilesWarp][4],
                                                int (&q)[kTilesWarp]) {
  const uint2 b = reinterpret_cast<const uint2*>(L)[lane];
  const int2 d = reinterpret_cast<const int2*>(L + 64)[t];
  const float2 b0 = reinterpret_cast<const float2*>(L + 72)[t];
  const float2 c1 = reinterpret_cast<const float2*>(L + 80)[t];
  const float b0t = t & 1 ? b0.y : b0.x, c1t = t & 1 ? c1.y : c1.x;  // column 2t + t%2
#pragma unroll
  for (int m = 0; m < kTilesWarp; ++m) {
    int acc[4] = {d.x, d.y, d.x, d.y};
    mma_s8(acc, make_int4((int)a[m][0], (int)a[m][1], (int)a[m][2], (int)a[m][3]), b.x, b.y);
    const int v = t & 2 ? (t & 1 ? acc[3] : acc[2]) : (t & 1 ? acc[1] : acc[0]);
    q[m] = exact2_int<kClamp>(v, b0t, c1t, lo, hi);
  }
}

// The outputs of run_last_narrow: lane i gathers column c of its rows
// i, i + 32, .. (row 16m + 8s + g of the item) from lane 4g + 2s + c by
// shuffles and writes each row whole (a pair where N_out is 2 and out is
// 2-byte aligned, else bytes).
__device__ __forceinline__ void store_narrow(int8_t* __restrict__ oi, int rows, int n_out,
                                             int lane, bool pairs, const int (&q)[kTilesWarp]) {
  const int src = 4 * (lane & 7) + 2 * ((lane >> 3) & 1);
#pragma unroll
  for (int u = 0; u < kRowRegs; ++u) {
    int v0 = 0, v1 = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 32u + 16h ..: m-tile 2u + h
      const int m = 2 * u + h;
      if (m >= kTilesWarp) break;
      const int w0 = __shfl_sync(~0u, q[m], src);
      const int w1 = __shfl_sync(~0u, q[m], src + 1);
      if ((lane >> 4) == h) v0 = w0, v1 = w1;
    }
    const int row = 32 * u + lane;
    if (row < rows) {
      int8_t* o = oi + row * n_out;
      const uint32_t v = pack_s8(v1, v0, 0u);
      if (pairs) {
        *reinterpret_cast<uint16_t*>(o) = (uint16_t)v;
      } else {
        o[0] = (int8_t)v;
        if (n_out > 1) o[1] = (int8_t)(v >> 8);
      }
    }
  }
}

// One layer on the work item's m-tiles: a (this layer's A fragments) ->
// a (the next layer's).  L: the layer's data, nt n-tiles.  n-tile j's
// pair of outputs of a row goes to the low half of register 2*(j/2) (+1
// for row g + 8) where j is odd, to its high half where j is even (the
// odd n-tile's pack_s8 shifts it there, or, for the last n-tile, a shift),
// which is the order feature_order gives (kernels/colfc.py).
template <bool kClamp>
__device__ __forceinline__ void run_layer(const int* L, int nt, float lo, float hi, int lane,
                                          int t, uint32_t (&a)[kTilesWarp][4]) {
  const uint2* bf = reinterpret_cast<const uint2*>(L) + lane;
  const int2* dv = reinterpret_cast<const int2*>(L + 64 * nt) + t;
  const float2* bv = reinterpret_cast<const float2*>(L + 72 * nt) + t;
  const float2* cv = reinterpret_cast<const float2*>(L + 80 * nt) + t;
  uint32_t na[kTilesWarp][4];  // every n-tile's mma reads a first
#pragma unroll
  for (int j = 0; j < kMaxWidth / 8; ++j) {
    if (j >= nt) break;
    const uint2 b = bf[32 * j];
    const int2 d = dv[4 * j];
    const float2 b0 = bv[4 * j], c1 = cv[4 * j];
    const int r = 2 * (j >> 1);
#pragma unroll
    for (int m = 0; m < kTilesWarp; ++m) {
      int acc[4] = {d.x, d.y, d.x, d.y};
      mma_s8(acc, make_int4((int)a[m][0], (int)a[m][1], (int)a[m][2], (int)a[m][3]), b.x, b.y);
      // features 8j + 2t and 8j + 2t + 1 of rows g and g + 8
      const int q0 = exact2_int<kClamp>(acc[0], b0.x, c1.x, lo, hi);
      const int q1 = exact2_int<kClamp>(acc[1], b0.y, c1.y, lo, hi);
      const int q2 = exact2_int<kClamp>(acc[2], b0.x, c1.x, lo, hi);
      const int q3 = exact2_int<kClamp>(acc[3], b0.y, c1.y, lo, hi);
      if (j & 1) {
        na[m][r] = pack_s8(q1, q0, na[m][r]);
        na[m][r + 1] = pack_s8(q3, q2, na[m][r + 1]);
      } else if (j + 1 < nt) {
        na[m][r] = pack_s8(q1, q0, 0u);
        na[m][r + 1] = pack_s8(q3, q2, 0u);
      } else {
        na[m][r] = pack_s8(q1, q0, 0u) << 16;
        na[m][r + 1] = pack_s8(q3, q2, 0u) << 16;
      }
    }
  }
  // features from 16 on: none past two n-tiles (the next layer's rows of W
  // for them are zero; this keeps the registers defined)
#pragma unroll
  for (int m = 0; m < kTilesWarp; ++m) {
    a[m][0] = na[m][0], a[m][1] = na[m][1];
    a[m][2] = nt > 2 ? na[m][2] : 0u, a[m][3] = nt > 2 ? na[m][3] : 0u;
  }
}

// The plan in shared memory: per layer a header (n-tiles nt, lo, hi, the
// offset of its data in words), then per layer its data: the B fragments
// [nt][32 lanes][2 words], then d, bias0 and c1, each [nt][8 columns].
// Warp w of block b takes items b * kWarps + w, then every
// gridDim.x * kWarps-th; item i is the kRowsItem samples from
// kRowsItem * i, its m-tile m rows 16m .. 16m + 15 of them.  kIn, kOut:
// K0 <= kNarrowIn (load_narrow), N_out <= kNarrowOut (the last layer
// through run_last_narrow and store_narrow).
template <bool kIn, bool kOut>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    col_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long B,
               const int* __restrict__ plan, int n_layers, int plan_words, int k0, int n_out,
               int items, int x_words, int out_pairs) {
  extern __shared__ __align__(16) int sp[];
  for (int i = threadIdx.x; i < plan_words / 4; i += kThreads)
    reinterpret_cast<int4*>(sp)[i] = __ldg(reinterpret_cast<const int4*>(plan) + i);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int step = gridDim.x * kWarps;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items; item += step) {
    const long long first = (long long)item * kRowsItem;
    const int rows = B - first < kRowsItem ? (int)(B - first) : kRowsItem;
    uint32_t a[kTilesWarp][4];
    if constexpr (kIn) {
      load_narrow(x + first * k0, rows, k0, lane, g, t, x_words, a);
    } else {
#pragma unroll
      for (int m = 0; m < kTilesWarp; ++m)
        load_a(x + first * k0, 16 * m + g, rows, k0, t, x_words, a[m]);
    }
    for (int l = 0; l < n_layers - kOut; ++l) {
      const int4 h = reinterpret_cast<const int4*>(sp)[l];
      const float lo = __int_as_float(h.y), hi = __int_as_float(h.z);
      if (lo > -128.0f || hi < 127.0f)
        run_layer<true>(sp + h.w, h.x, lo, hi, lane, t, a);
      else
        run_layer<false>(sp + h.w, h.x, lo, hi, lane, t, a);
    }
    if constexpr (kOut) {
      const int4 h = reinterpret_cast<const int4*>(sp)[n_layers - 1];
      const float lo = __int_as_float(h.y), hi = __int_as_float(h.z);
      int q[kTilesWarp];
      if (lo > -128.0f || hi < 127.0f)
        run_last_narrow<true>(sp + h.w, lo, hi, lane, t, a, q);
      else
        run_last_narrow<false>(sp + h.w, lo, hi, lane, t, a, q);
      store_narrow(out + first * n_out, rows, n_out, lane, out_pairs, q);
    } else {
#pragma unroll
      for (int m = 0; m < kTilesWarp; ++m)
        store_rows(out + first * n_out, 16 * m + g, rows, n_out, t, out_pairs, a[m]);
    }
  }
}

// The launch's resident blocks: SMs x the blocks an SM holds, by
// registers (the occupancy the runtime reports, asked once per device and
// instantiation) and by the plan's shared memory.  The first launch on a
// device also allows the kernel the most dynamic shared memory a block
// may opt in to.
template <bool kIn, bool kOut>
cudaError_t resident_blocks(int smem, int* blocks) {
  struct Device {
    std::atomic<int> ready{0}, sms{0}, per_sm{0}, smem_sm{0}, reserved{0};
  };
  constexpr int kDevices = 16;
  static Device cache[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Device local;
  Device& c = dev < kDevices ? cache[dev] : local;
  if (!c.ready.load(std::memory_order_acquire)) {
    int sms = 0, per_sm = 0, smem_sm = 0, reserved = 0, optin = 0;
    const auto kernel = col_kernel<kIn, kOut>;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) ||
        (err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)))
      return err;
    c.sms.store(sms, std::memory_order_relaxed);
    c.per_sm.store(per_sm, std::memory_order_relaxed);
    c.smem_sm.store(smem_sm, std::memory_order_relaxed);
    c.reserved.store(reserved, std::memory_order_relaxed);
    c.ready.store(1, std::memory_order_release);
  }
  const int by_smem = c.smem_sm.load(std::memory_order_relaxed) /
                      (smem + c.reserved.load(std::memory_order_relaxed));
  const int by_regs = c.per_sm.load(std::memory_order_relaxed);
  const int per_sm = by_regs < by_smem ? by_regs : by_smem;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = c.sms.load(std::memory_order_relaxed) * per_sm;
  return cudaSuccess;
}

template <bool kIn, bool kOut>
cudaError_t launch(const int8_t* x, int8_t* out, long long B, const int* plan, int n_layers,
                   int plan_words, int k0, int n_out, cudaStream_t stream) {
  const int smem = plan_words * 4;
  int blocks = 0;
  const cudaError_t err = resident_blocks<kIn, kOut>(smem, &blocks);
  if (err != cudaSuccess) return err;
  const long long items = (B + kRowsItem - 1) / kRowsItem;
  const long long need = (items + kWarps - 1) / kWarps;
  const long long grid = need < blocks ? need : blocks;
  if (items > 0x7fffffff - grid * kWarps) return cudaErrorInvalidValue;  // int items
  const int x_words = k0 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const int out_pairs = n_out % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 2 == 0;
  col_kernel<kIn, kOut><<<(unsigned)grid, kThreads, smem, stream>>>(
      x, out, B, plan, n_layers, plan_words, k0, n_out, (int)items, x_words, out_pairs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  plan: the int32 buffer of
// kernels/colfc.py::pack_col_plan (plan_words words, a multiple of 4,
// 16-byte aligned).  Returns the CUDA error code of the launch.
extern "C" int mf_colfc(const void* x, void* out, long long B, const void* plan, int n_layers,
                        int plan_words, int k0, int n_out, void* stream) {
  if (B <= 0 || n_layers <= 0 || k0 <= 0 || k0 > kMaxWidth || n_out <= 0 ||
      n_out > kMaxWidth || plan_words % 4 != 0 || reinterpret_cast<uintptr_t>(plan) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  auto* op = static_cast<int8_t*>(out);
  const auto* pp = static_cast<const int*>(plan);
  auto s = static_cast<cudaStream_t>(stream);
  const bool narrow_in = k0 <= kNarrowIn, narrow_out = n_out <= kNarrowOut;
  auto go = narrow_in ? (narrow_out ? launch<true, true> : launch<true, false>)
                      : (narrow_out ? launch<false, true> : launch<false, false>);
  return (int)go(xp, op, B, pp, n_layers, plan_words, k0, n_out, s);
}
