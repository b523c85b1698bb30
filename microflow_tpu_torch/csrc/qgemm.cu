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
// What bounds it on an H100: bytes, at best.  Each X byte feeds N <= 256
// multiply-adds (the shapes served have K = 1..256, and 4000 once, with
// N = 4), far below the ~600 operations per byte where the tensor cores
// would be the limit.  But the products of the wide shapes cost the CUDA
// cores more than their bytes, and every output costs the epilogue three
// conversions on the SM's 16-a-clock pipe, so there are two paths, chosen
// by a rule on shape alone (kernels/qgemm.py::qgemm_path, which the wrapper
// passes in as `path`):
//
// - "dp4a" (qgemm_rows, K < 64): a persistent grid, as many blocks as the
//   SMs hold (occupancy from the runtime), each owning a chunk of up to
//   kChunk output columns.  A block stages its chunk of W (K x 64 bytes at
//   most) and the chunk's epilogue constants in shared memory once, then
//   walks work items of rows with a grid stride.  A group of 1, 2 or 4
//   lanes (N <= 16, <= 32, more) owns each row, a lane kCols of its
//   columns: the lane reads the row's K bytes straight from device memory
//   into registers (one 8-byte load at K = 8, one 16-byte load at K = 16,
//   two at K = 32; words or bytes where K or X is not aligned), with no
//   shared-memory stage and no barrier in the row loop, and the next work
//   item's rows are loaded before the current item's products, epilogue
//   and stores.  Products and row sums by __dp4a, against W words read
//   from shared memory four columns at a time (the same address for every
//   lane of a warp where one lane owns a row); each W word and constant
//   read serves the item's rows.  The epilogue clamps y before rounding
//   and rounds by a truncation (round_byte below): two conversions an
//   output, not three, and the same bits.  A row's outputs leave in one
//   16-byte store a lane where N % 16 == 0, else in words or bytes.
//   kCols, kRows, kRowsWide and kRowMinBlocks were chosen by
//   scripts/torch_qgemm_sweep.py --narrow (PERF.md).
//   At K >= 64, "dp4a" (forced for measurement, or past kMmaMaxK) takes
//   the shared-memory tiles of qgemm_kernel: X staged 32 bytes of K at a
//   time, all accumulators in registers, the epilogue before one store.
// - "mma" (qgemm_mma, 64 <= K <= kMmaMaxK): the products on the int8
//   tensor cores, mma.sync m16n8k32 (mma_s8.cuh), in op_pw_mma's
//   orientation (segment_ops.cuh): output channels on the MMA's M
//   (A = W^T), rows of X on its N (B; X is [M][K], the "col" layout B
//   wants).  W arrives with every call (the "pallas" backend may swap
//   weights), so each block first builds the A fragments of its up to
//   kMaxTiles m-tiles of 16 output channels in shared memory from W, in
//   kernels/flatpack.py::mma_fragments' order, one coalesced pass over W
//   that transposes 4x4 blocks of bytes.  X goes through no shared memory:
//   with the same K permutation inside each 64 channels, a lane reads 16
//   contiguous bytes of its row for two k-steps with one load, straight
//   from device memory.  What paces this path is the distinct bytes of X in
//   flight: with one warp an m-tile, the warps of a block would all read
//   the same rows.  So a warp's work item is kTiles tiles of 8 rows by every
//   m-tile of its block: a row is read by one warp of each block of
//   columns (whose blocks are neighbours in the grid, so the second read
//   comes from L2), and each B word serves up to kMaxTiles MMAs.  The next
//   64 channels (past the item's last, the next item's first) are loaded
//   before the current ones' MMAs and the epilogue.  The row sums ride
//   along: a __dp4a against ones per B word, two shuffles over the quad
//   that holds a row and two that bring rows 2t and 2t+1 to the lanes that
//   hold their accumulators.  The epilogue is epilogue.cuh's (the same
//   operations as qgemm_kernel's), its constants staged in shared memory;
//   a 4x4 byte transpose over lanes (two shuffles) turns each lane's four
//   outputs into one word of four adjacent channels, stored with one
//   4-byte store.  kTiles, kMaxTiles and kMinBlocks were chosen by
//   scripts/torch_qgemm_sweep.py (PERF.md).
//
// Rounding: the epilogue is written with __fmul_rn/__fadd_rn, and the file is
// built with -fmad=false, so bias0 + c1*q is a multiply and then an add, as in
// the reference, never one fused multiply-add.  roundf rounds half away from
// zero.  y is clamped in f32 before the conversion, which is then exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// The launch of qgemm_kernel, for "dp4a" at K >= 64: the tile's columns
// adapt to N, its K slice is 32 bytes.
template <int BN>
cudaError_t launch_tiles(const int8_t* x, const int8_t* w, const int32_t* wzp, const int32_t* d,
                         const float* bias0, const float* c1, int8_t* out, long long M, int K,
                         int N, float lo, float hi, int vec_x, int vec_out, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / 4)) * 4;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  qgemm_kernel<BN, 32><<<grid, kThreads, 0, stream>>>(x, w, wzp, d, bias0, c1, out, M, K, N, lo,
                                                      hi, vec_x, vec_out);
  return cudaGetLastError();
}

// --- the narrow path (K < 64) ------------------------------------------------

constexpr int kCols = 16;         // output columns a lane
constexpr int kChunk = 64;        // output columns a block: up to kChunk / kCols lanes a row
constexpr int kStride = 72;       // words a staged row: kChunk, and 4 after every 32 columns
constexpr int kRows = 3;          // rows a thread per work item, K <= 8
constexpr int kRowsWide = 2;      // rows a thread per work item, 8 < K <= 32 (1 above)
constexpr int kRowMinBlocks = 3;  // blocks an SM (__launch_bounds__)
static_assert(kStride == kChunk + kChunk / 8 && 32 % kCols == 0, "the staged row's padding");

__host__ __device__ constexpr int rows_per_thread(int kw) {
  return kw <= 2 ? kRows : kw <= 8 ? kRowsWide : 1;
}

// The rows p, p + tile, ... (R of them) of X into registers, KW words each,
// zero past K and for rows past M.  mode 2: K == 4 * KW and X aligned to
// min(16, 4 * KW) bytes (vector loads of up to 16 bytes); 1: K % 4 == 0
// and X 4-byte aligned (words); 0: bytes.
template <int KW, int R>
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ x, long long p, int tile,
                                          long long M, int K, int mode, uint32_t (&v)[R][KW]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int i = 0; i < KW; ++i) v[j][i] = 0;
    const long long row = p + (long long)j * tile;
    if (row >= M) continue;
    const int8_t* r = x + row * K;
    if (mode == 2) {
      if constexpr (KW == 1) {
        v[j][0] = __ldg(reinterpret_cast<const uint32_t*>(r));
      } else if constexpr (KW == 2) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(r));
        v[j][0] = u.x, v[j][1] = u.y;
      } else {
#pragma unroll
        for (int i = 0; i < KW; i += 4) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(r) + i / 4);
          v[j][i] = u.x, v[j][i + 1] = u.y, v[j][i + 2] = u.z, v[j][i + 3] = u.w;
        }
      }
    } else if (mode == 1) {
#pragma unroll
      for (int i = 0; i < KW; ++i)
        if (4 * i < K) v[j][i] = __ldg(reinterpret_cast<const uint32_t*>(r) + i);
    } else {
#pragma unroll
      for (int i = 0; i < KW; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * i + b < K) v[j][i] |= (uint32_t)(uint8_t)__ldg(r + 4 * i + b) << (8 * b);
    }
  }
}

// The epilogue with two conversions, not requant_byte's three: y =
// bias0 + c1 * f32(q) (the multiply, then the add) clamped to [lo, hi]
// first (lo and hi are integers, so rounding the clamped y gives the
// clamped rounding), then roundf(y) as trunc(y + copysign(0.5 - 2^-25,
// y)), exact for every |y| <= 129 (0.5 itself would round y = 0.5 - 2^-25
// up to 1).  The low byte of the result is the output.
__device__ __forceinline__ uint32_t round_byte(int q, float b0, float c1, float lo, float hi) {
  const float y = fminf(fmaxf(mf_affine(b0, c1, q), lo), hi);
  return (uint32_t)__float2int_rz(__fadd_rn(y, copysignf(__int_as_float(0x3EFFFFFF), y)));
}

// One launch serves output columns n0 = blockIdx.y * kChunk .. + kChunk - 1
// and, with a grid stride, work items of R * tile rows (tile = 32 / L
// rows, L = 1 << lanes_log2 lanes a row): warp w of block b takes items
// b * kWarps + w, then every gridDim.x * kWarps-th.  Lane g * L + s
// takes rows item * R * tile + g + tile * j (j < R) and columns n0 +
// kCols * s .. + kCols - 1.  Shared memory, staged once a block: rows 0 ..
// KW-1 hold the W words (column n's bytes k = 4i .. 4i+3 in row i), rows
// KW .. KW+3 -wzp, d, bias0 and c1; column c of the chunk sits at word
// c + 4 * (c / 32), so the lanes of a warp that read different columns hit
// different banks.  Columns past N are 0.
template <int KW>
__global__ void __launch_bounds__(kThreads, kRowMinBlocks) qgemm_rows(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ wzp, const int32_t* __restrict__ d,
    const float* __restrict__ bias0, const float* __restrict__ c1,
    int8_t* __restrict__ out, long long M, int K, int N, float lo, float hi, int lanes_log2,
    int items, int x_mode, int out_mode) {
  constexpr int R = rows_per_thread(KW);
  constexpr int G = kCols / 4;  // column groups of four a lane
  __shared__ __align__(16) uint32_t sm[(KW + 4) * kStride];
  const int n0 = blockIdx.y * kChunk;
  for (int e = threadIdx.x; e < (KW + 4) * kChunk; e += kThreads) {
    const int i = e / kChunk, c = e % kChunk, n = n0 + c;
    uint32_t v = 0;
    if (n < N) {
      if (i < KW) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * i + b < K)
            v |= (uint32_t)(uint8_t)__ldg(w + (long long)(4 * i + b) * N + n) << (8 * b);
      } else if (i == KW) {
        v = 0u - (uint32_t)__ldg(wzp + n);
      } else if (i == KW + 1) {
        v = (uint32_t)__ldg(d + n);
      } else {
        v = __float_as_uint(__ldg((i == KW + 2 ? bias0 : c1) + n));
      }
    }
    sm[i * kStride + c + 4 * (c >> 5)] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, L = 1 << lanes_log2, tile = 32 >> lanes_log2;
  const int s = lane & (L - 1), g = lane >> lanes_log2, cb = kCols * s;
  const int live = min(kCols, N - n0 - cb);  // the lane's columns below N
  const uint4* col = reinterpret_cast<const uint4*>(sm + cb + 4 * (cb >> 5));
  constexpr int kRowQ = kStride / 4;  // uint4 a staged row
  const int step = gridDim.x * kWarps, rows_item = R * tile;
  int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  uint32_t cur[R][KW];
  if (item < items) load_rows<KW, R>(x, (long long)item * rows_item + g, tile, M, K, x_mode, cur);
  for (; item < items; item += step) {
    const long long p = (long long)item * rows_item + g;
    uint32_t nxt[R][KW];
    const bool more = item + step < items;
    if (more) load_rows<KW, R>(x, p + (long long)step * rows_item, tile, M, K, x_mode, nxt);

    // Each group of four columns is finished (products, then the epilogue
    // into one word of four bytes a row) before the next, so only 4 * R
    // accumulators are live; every group is computed (past N from zeros),
    // so no branch parts them.  q = acc + rs * -wzp.
    int rs[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      rs[j] = 0;
#pragma unroll
      for (int i = 0; i < KW; ++i) rs[j] = __dp4a((int)cur[j][i], 0x01010101, rs[j]);
    }
    uint32_t word[R][G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const uint4 dv = col[(KW + 1) * kRowQ + c];
      int acc[R][4];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[j][0] = (int)dv.x, acc[j][1] = (int)dv.y, acc[j][2] = (int)dv.z, acc[j][3] = (int)dv.w;
      }
#pragma unroll
      for (int i = 0; i < KW; ++i) {
        const uint4 wv = col[i * kRowQ + c];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int xv = (int)cur[j][i];
          acc[j][0] = __dp4a(xv, (int)wv.x, acc[j][0]);
          acc[j][1] = __dp4a(xv, (int)wv.y, acc[j][1]);
          acc[j][2] = __dp4a(xv, (int)wv.z, acc[j][2]);
          acc[j][3] = __dp4a(xv, (int)wv.w, acc[j][3]);
        }
      }
      const uint4 z = col[KW * kRowQ + c], b0 = col[(KW + 2) * kRowQ + c],
                  cc = col[(KW + 3) * kRowQ + c];
      const int zs[4] = {(int)z.x, (int)z.y, (int)z.z, (int)z.w};
      const float bs[4] = {__uint_as_float(b0.x), __uint_as_float(b0.y), __uint_as_float(b0.z),
                           __uint_as_float(b0.w)};
      const float cs[4] = {__uint_as_float(cc.x), __uint_as_float(cc.y), __uint_as_float(cc.z),
                           __uint_as_float(cc.w)};
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint32_t v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[b] = round_byte(acc[j][b] + rs[j] * zs[b], bs[b], cs[b], lo, hi);
        word[j][c] = __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040),
                                 0x5410);
      }
    }

    // Stores: out_mode 2, one kCols-byte store a lane (N % kCols == 0, out
    // aligned); 1, words (N % 4 == 0, out 4-byte aligned); 0, bytes.
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = p + (long long)j * tile;
      if (row >= M || live <= 0) continue;
      int8_t* o = out + row * N + n0 + cb;
      if (out_mode == 2) {
        if constexpr (G == 4)
          *reinterpret_cast<uint4*>(o) = make_uint4(word[j][0], word[j][1], word[j][2], word[j][3]);
        else if constexpr (G == 2)
          *reinterpret_cast<uint2*>(o) = make_uint2(word[j][0], word[j][1]);
        else
          *reinterpret_cast<uint32_t*>(o) = word[j][0];
      } else if (out_mode == 1) {
#pragma unroll
        for (int c = 0; c < G; ++c)
          if (4 * c < live) reinterpret_cast<uint32_t*>(o)[c] = word[j][c];
      } else {
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (4 * c + b < live) o[4 * c + b] = (int8_t)(word[j][c] >> (8 * b));
      }
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < KW; ++i) cur[j][i] = nxt[j][i];
    }
  }
}

// Blocks a launch of `kernel` keeps resident on the current device: its SMs
// times the blocks an SM holds at kThreads threads (ptxas' registers and
// the static shared memory decide).  Cached per kernel and device.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* blocks) {
  constexpr int kDevices = 16;
  static std::atomic<int> cache[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && (*blocks = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kDevices) cache[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// The launch of qgemm_rows: KW words of K a row; lanes a row as few as
// hold a chunk's columns; column chunks on grid y; the resident blocks
// split over the chunks on grid x, no more than there are warps of items.
template <int KW>
cudaError_t launch_rows(const int8_t* x, const int8_t* w, const int32_t* wzp, const int32_t* d,
                        const float* bias0, const float* c1, int8_t* out, long long M, int K,
                        int N, float lo, float hi, cudaStream_t s) {
  constexpr int R = rows_per_thread(KW);
  const int span = N < kChunk ? N : kChunk;
  int lanes_log2 = 0;
  while ((kCols << lanes_log2) < span) ++lanes_log2;
  const int chunks = (N + kChunk - 1) / kChunk;
  const long long rows_item = (long long)R * (32 >> lanes_log2);
  const long long items = (M + rows_item - 1) / rows_item;
  int blocks = 0;
  const cudaError_t err = resident_blocks(qgemm_rows<KW>, &blocks);
  if (err != cudaSuccess) return err;
  long long bx = blocks / chunks > 0 ? blocks / chunks : 1;
  const long long need = (items + kWarps - 1) / kWarps;
  if (bx > need) bx = need;
  if (items > 0x7fffffff - bx * kWarps) return cudaErrorInvalidValue;  // int item indices
  const int vec = KW < 4 ? 4 * KW : 16;  // the vector load's bytes
  const int x_mode = K == 4 * KW && reinterpret_cast<uintptr_t>(x) % vec == 0 ? 2
                     : K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 ? 1 : 0;
  const int out_mode = N % kCols == 0 && reinterpret_cast<uintptr_t>(out) % kCols == 0 ? 2
                       : N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0 ? 1 : 0;
  qgemm_rows<KW><<<dim3((unsigned)bx, (unsigned)chunks), kThreads, 0, s>>>(
      x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, lanes_log2, (int)items, x_mode, out_mode);
  return cudaGetLastError();
}

// The narrow path by K: the smallest KW with 4 * KW >= K.
template <int KW>
cudaError_t launch_narrow(const int8_t* x, const int8_t* w, const int32_t* wzp, const int32_t* d,
                          const float* bias0, const float* c1, int8_t* out, long long M, int K,
                          int N, float lo, float hi, cudaStream_t s) {
  if constexpr (KW < 16) {
    if (K > 4 * KW)
      return launch_narrow<2 * KW>(x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, s);
  }
  return launch_rows<KW>(x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, s);
}

// --- the tensor-core path ----------------------------------------------------

constexpr int kTiles = 2;             // tiles of 8 rows a warp's work item
constexpr int kItemRows = 8 * kTiles;  // rows of X a work item
constexpr int kMaxTiles = 4;          // m-tiles of 16 output channels a block
constexpr int kMinBlocks = 3;         // blocks an SM (__launch_bounds__)
constexpr int kMaxFragBytes = 65536;  // the most A fragment bytes a block stages
constexpr int kMmaMaxK = 4096;        // one m-tile's 128 units of 512 bytes fill them
constexpr int kMaxBlocks = 1024;      // blocks, all column chunks together

// The B words of channels kb.. of the work item from row p0, lane 4g + t
// reading row p0 + 8j + g for tile j: where more than 32 channels remain,
// its 16 bytes kb+16t..kb+16t+15 (a pair of A units), else its 8 bytes
// kb+8t..kb+8t+7 in words 0 and 1.  Bytes past K, and rows past M, are 0.
// VEC = 2: K % 16 == 0 and X 16-byte aligned (one vector load); 1: K % 4
// == 0 and X 4-byte aligned (words); 0: bytes.
template <int VEC>
__device__ __forceinline__ void load_b(const int8_t* x, long long p0, long long M, int K, int kb,
                                       int g, int t, uint32_t (&w)[kTiles][4]) {
  const bool pair = K - kb > 32;
  const int c = kb + (pair ? 16 : 8) * t, nw = pair ? 4 : 2;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[j][i] = 0;
    const long long row = p0 + 8 * j + g;
    if (row >= M || c >= K) continue;
    const int8_t* p = x + row * K + c;
    if constexpr (VEC == 2) {  // c + 4 * nw <= K
      if (pair) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        w[j][0] = v.x, w[j][1] = v.y, w[j][2] = v.z, w[j][3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[j][0] = v.x, w[j][1] = v.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= nw || c + 4 * i >= K) continue;
        if constexpr (VEC == 1) {
          w[j][i] = __ldg(reinterpret_cast<const uint32_t*>(p + 4 * i));
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c + 4 * i + b < K) w[j][i] |= (uint32_t)(uint8_t)__ldg(p + 4 * i + b) << (8 * b);
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t requant_byte(int acc, int rs, int zp, int d, float b0, float c1,
                                                 float lo, float hi) {
  return (uint8_t)mf_round_away(mf_affine(b0, c1, acc - rs * zp + d), lo, hi);
}

// One launch serves output channels n0 = blockIdx.x * 16 * mt .. +16*mt-1
// (mt <= kMaxTiles m-tiles; the blocks of one range of rows are neighbours
// in the grid, so they read X while it is in L2) and work items
// blockIdx.y * ipb .. +ipb-1 of kItemRows rows each.  Warp w takes the
// block's items w, w + kWarps, ..., and every m-tile of each: a row of X is
// read by one warp of the block, so the warps' loads in flight are all
// distinct.  Dynamic shared memory: the epilogue constants of the block's
// channels, int4 {wzp, d, bias0, c1} each, then their A fragments,
// [mt][units][32 lanes][16 bytes], units = ceil(K / 32); rows past N and
// channels past K are 0.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) qgemm_mma(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ wzp, const int32_t* __restrict__ d,
    const float* __restrict__ bias0, const float* __restrict__ c1,
    int8_t* __restrict__ out, long long M, int K, int N, float lo, float hi, int mt, int items,
    int ipb, int vec_w, int vec_out) {
  extern __shared__ int4 smem[];
  int4* consts = smem;
  int4* frag = smem + 16 * mt;
  const int units = (K + 31) >> 5;
  const int n0 = blockIdx.x * 16 * mt;
  const int live = min(mt, (N - n0 + 15) >> 4);  // m-tiles with a column < N

  for (int r = threadIdx.x; r < 16 * mt; r += kThreads) {
    const int n = n0 + r;
    consts[r] = n < N ? make_int4(__ldg(wzp + n), __ldg(d + n), __float_as_int(__ldg(bias0 + n)),
                                  __float_as_int(__ldg(c1 + n)))
                      : make_int4(0, 0, 0, 0);
  }
  // The fragments: thread e takes channels c..c+3 (c = 4 * (e / quads)) of
  // columns n..n+3 (n = n0 + 4 * (e % quads)), so neighbouring threads read
  // neighbouring words of a row of W; the 4x4 block is transposed into one
  // word of four channels per column, and each word goes to its lane and
  // register: where more than 32 channels remain from kb = c & ~63, lane
  // (c - kb) / 16 of unit kb / 32 + ((c - kb) / 8) % 2, else lane
  // (c - kb) / 8 of unit kb / 32; register half ((c - kb) / 4) % 2 (words
  // 0-1 or 2-3), and the row's half (g or g + 8) within it.
  {
    uint32_t* fw = reinterpret_cast<uint32_t*>(frag);
    const int quads = 4 * mt;
    for (int e = threadIdx.x; e < units * 8 * quads; e += kThreads) {
      const int nq = e % quads, c = 4 * (e / quads), n = n0 + 4 * nq;
      uint32_t rows[4], cols[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = c + r;
        uint32_t v = 0;
        if (k < K && n < N) {
          const int8_t* p = w + (long long)k * N + n;
          if (vec_w) {
            v = __ldg(reinterpret_cast<const uint32_t*>(p));
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (n + b < N) v |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * b);
          }
        }
        rows[r] = v;
      }
      transpose4(rows, cols);
      const int kb = c & ~63, off = c - kb;
      const bool pair = K - kb > 32;
      const int unit = (kb >> 5) + (pair ? (off >> 3) & 1 : 0);
      const int lane_t = pair ? off >> 4 : off >> 3;
      const int half = (off >> 2) & 1;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = 4 * nq + b;  // the block's row (output channel n0 + r)
        fw[(((r >> 4) * units + unit) * 32 + 4 * (r & 7) + lane_t) * 4 + 2 * half +
           ((r >> 3) & 1)] = cols[b];
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int first = blockIdx.y * ipb, last = min(first + ipb, items);
  // Every tile's B words are read before the MMAs, and the next 64
  // channels' (past the item's last, the next item's first 64) before this
  // 64's, so the loads overlap each other, the MMAs and the epilogue.  Each
  // A fragment serves kTiles MMAs, each B word kMaxTiles.  Every loop and
  // branch around an MMA is warp-uniform, as mma.sync needs.
  int item = first + warp;
  uint32_t cur[kTiles][4];
  if (item < last) load_b<VEC>(x, (long long)item * kItemRows, M, K, 0, g, t, cur);
  for (; item < last; item += kWarps) {
    const long long p0 = (long long)item * kItemRows;
    int acc[kMaxTiles][kTiles][4], rs[kTiles];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      rs[j] = 0;
#pragma unroll
      for (int m = 0; m < kMaxTiles; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;
    }
    for (int kb = 0; kb < K; kb += 64) {
      const bool more = kb + 64 < K, next = more || item + kWarps < last;
      const bool pair = K - kb > 32;
      uint32_t nxt[kTiles][4];
      if (more) load_b<VEC>(x, p0, M, K, kb + 64, g, t, nxt);
      else if (next) load_b<VEC>(x, p0 + kWarps * kItemRows, M, K, 0, g, t, nxt);
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) rs[j] = __dp4a((int)cur[j][i], 0x01010101, rs[j]);
      const int4* a = frag + (kb >> 5) * 32 + lane;
#pragma unroll
      for (int m = 0; m < kMaxTiles; ++m) {
        if (m < live) {
          const int4 a0 = a[m * units * 32];
#pragma unroll
          for (int j = 0; j < kTiles; ++j) mma_s8(acc[m][j], a0, cur[j][0], cur[j][1]);
          if (pair) {
            const int4 a1 = a[m * units * 32 + 32];
#pragma unroll
            for (int j = 0; j < kTiles; ++j) mma_s8(acc[m][j], a1, cur[j][2], cur[j][3]);
          }
        }
      }
      if (next) {
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) cur[j][i] = nxt[j][i];
      }
    }

    // Epilogue: lane 4g + t holds, of m-tile m, rows p0 + 8j + 2t + (0, 1)
    // of channels na = n0 + 16m + g (registers 0, 1) and nb = na + 8 (2, 3).
    // The row sums: the quad of row 8j + g adds its parts, then rows 2t and
    // 2t + 1 come from lanes 8t and 8t + 4.
    int r0[kTiles], r1[kTiles];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      int r = rs[j];
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      r0[j] = __shfl_sync(0xffffffffu, r, 8 * t);
      r1[j] = __shfl_sync(0xffffffffu, r, 8 * t + 4);
    }
#pragma unroll
    for (int m = 0; m < kMaxTiles; ++m) {
      if (m >= live) continue;
      const int nm = n0 + 16 * m, na = nm + g, nb = na + 8;
      const int4 qa = consts[16 * m + g], qb = consts[16 * m + g + 8];
      const float ba = __int_as_float(qa.z), ca = __int_as_float(qa.w);
      const float bb = __int_as_float(qb.z), cb = __int_as_float(qb.w);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const long long p = p0 + 8 * j + 2 * t;
        const uint32_t v0 = requant_byte(acc[m][j][0], r0[j], qa.x, qa.y, ba, ca, lo, hi);
        const uint32_t v1 = requant_byte(acc[m][j][1], r1[j], qa.x, qa.y, ba, ca, lo, hi);
        const uint32_t v2 = requant_byte(acc[m][j][2], r0[j], qb.x, qb.y, bb, cb, lo, hi);
        const uint32_t v3 = requant_byte(acc[m][j][3], r1[j], qb.x, qb.y, bb, cb, lo, hi);
        if (vec_out) {
          // Lanes g = 4h + i (i = 0..3) of one t hold, as bytes (v0..v3),
          // row 4h+i of the 4x4 matrix whose column s is the word for row
          // p + (s & 1), channels nm + 4h + 8 * (s >> 1) .. +3; transpose
          // it over the four lanes (lane xor 8, then xor 4), lane i keeping
          // column i.
          const int i = g & 3;
          const uint32_t v = v0 | v1 << 8 | v2 << 16 | v3 << 24;
          uint32_t y = __shfl_xor_sync(0xffffffffu, v, 8);
          const uint32_t u = i & 2 ? __byte_perm(y, v, 0x7632) : __byte_perm(v, y, 0x5410);
          y = __shfl_xor_sync(0xffffffffu, u, 4);
          const uint32_t word = i & 1 ? __byte_perm(u, y, 0x3715) : __byte_perm(u, y, 0x6240);
          const long long pr = p + (i & 1);
          const int n = nm + 4 * (g >> 2) + 8 * (i >> 1);
          if (pr < M && n < N) *reinterpret_cast<uint32_t*>(out + pr * N + n) = word;
        } else {
          if (p < M) {
            if (na < N) out[p * N + na] = (int8_t)v0;
            if (nb < N) out[p * N + nb] = (int8_t)v2;
          }
          if (p + 1 < M) {
            if (na < N) out[(p + 1) * N + na] = (int8_t)v1;
            if (nb < N) out[(p + 1) * N + nb] = (int8_t)v3;
          }
        }
      }
    }
  }
}

// The launch of qgemm_mma: as many m-tiles a block as cover N, at most
// kMaxTiles, fewer where their fragments would pass kMaxFragBytes; work
// items split evenly over at most kMaxBlocks blocks, a multiple of kWarps
// items a block.
template <int VEC>
cudaError_t launch_mma(const int8_t* x, const int8_t* w, const int32_t* wzp, const int32_t* d,
                       const float* bias0, const float* c1, int8_t* out, long long M, int K, int N,
                       float lo, float hi, int vec_w, int vec_out, cudaStream_t s) {
  const int units = (K + 31) / 32;
  int mt = (N + 15) / 16 < kMaxTiles ? (N + 15) / 16 : kMaxTiles;
  while (mt > 1 && mt * units * 512 > kMaxFragBytes) --mt;
  const int chunks = (N + 16 * mt - 1) / (16 * mt);
  const long long items = (M + kItemRows - 1) / kItemRows;
  if (items > 0x7fffffff - kMaxBlocks * kWarps) return cudaErrorInvalidValue;  // int item indices
  long long by = (items + kWarps - 1) / kWarps;
  const long long cap = kMaxBlocks / chunks > 0 ? kMaxBlocks / chunks : 1;
  if (by > cap) by = cap;
  const long long ipb = ((items + by - 1) / by + kWarps - 1) / kWarps * kWarps;
  by = (items + ipb - 1) / ipb;
  const int smem = mt * (units * 512 + 16 * 16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qgemm_mma<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  qgemm_mma<VEC><<<dim3((unsigned)chunks, (unsigned)by), kThreads, smem, s>>>(
      x, w, wzp, d, bias0, c1, out, M, K, N, lo, hi, mt, (int)items, (int)ipb, vec_w, vec_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch, 0 on success.  vec_x: K % 4 == 0 and x 4-byte aligned.
// vec_out: N % 4 == 0 and out 4-byte aligned.  path: 0 = "dp4a"
// (qgemm_rows for K < 64, qgemm_kernel above), 1 = "mma" (qgemm_mma, K <=
// kMmaMaxK), as kernels/qgemm.py::qgemm_path chose it.
extern "C" int mf_qgemm(const void* x, const void* w, const void* wzp, const void* d,
                        const void* bias0, const void* c1, void* out, long long M, int K, int N,
                        float lo, float hi, int vec_x, int vec_out, int path, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || path < 0 || path > 1 || (path == 1 && K > kMmaMaxK))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* zp = static_cast<const int32_t*>(wzp);
  const auto* dp = static_cast<const int32_t*>(d);
  const auto* bp = static_cast<const float*>(bias0);
  const auto* cp = static_cast<const float*>(c1);
  auto* op = static_cast<int8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (path == 1) {
    const int vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
    if (K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
      err = launch_mma<2>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_w, vec_out, s);
    else if (vec_x)
      err = launch_mma<1>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_w, vec_out, s);
    else
      err = launch_mma<0>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_w, vec_out, s);
  } else if (K < 64)
    err = launch_narrow<1>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, s);
  else if (N <= 16)
    err = launch_tiles<16>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_x, vec_out, s);
  else if (N <= 32)
    err = launch_tiles<32>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_x, vec_out, s);
  else
    err = launch_tiles<64>(xp, wp, zp, dp, bp, cp, op, M, K, N, lo, hi, vec_x, vec_out, s);
  return (int)err;
}
