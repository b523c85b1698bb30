// The weight gradient of a 1x1, stride-1, unpadded Conv2D, normalized,
// rounded and saturated per sample and folded over the batch into the
// gradient accumulator, for Hopper (sm_90a), bit-equal to the trainer's
// plain torch chain (train/gradients.py::conv_weight_grad_sample, then
// train/optimizer.py::plain_fold):
//
//   dw[b, f, c]   = sum_p md[b, p, f] * (x[b, p, c] - in_zp)   (wrapping i32)
//   norm[b, f]    = sum_p |md[b, p, f]|                        (wrapping i32;
//                   |INT_MIN| stays INT_MIN, as torch's int32 abs)
//   q[b, f, c]    = sat_int8(round_away(f32(dw) / f32(norm)))  (IEEE divide;
//                   0/0 -> 0, +-x/0 -> 127 / -128)
//   acc_out[f, c] = acc_in[f, c] + sum_b q[b, f, c]            (wrapping i32)
//
// md is the masked dOut, [B, P, F] int32; x the layer's input, [B, P, C]
// int8.  The batch sum is the fold of record only where it cannot saturate
// (optimizer.fold_is_plain_sum), which the caller checks; its order is then
// free, so integer atomics give exact, run-to-run identical sums.
//
// It replaces no TPU kernel: the JAX package's backward is plain jnp.  It
// was added because the plain chain materialises [B, F, C] int64 and f32
// tensors and casts them back and forth (9 ms of a 16 ms person_detect
// step at batch 1024), where the inputs are a few tens of MB.
//
// What bounds it on an H100: instructions.  At person_detect's batch 1024
// the four layers read ~46 MB (14 us at 3.35 TB/s) but take 1.5 G int32
// multiply-adds and up to 110 M divides, each about eight instructions
// (rcp, Newton steps, a range check), plus the rounding: its least time is
// the multiply-adds', 90 us at 64 a clock and SM.  So the design keeps
// every intermediate in registers and spends few instructions on anything
// else: a block owns a 64 x 64 tile of (f, c) and a chunk of the batch,
// sized so that one wave of blocks covers the work; each thread a 4 x 4
// register tile of entries, whose 16 products a position take one 16-byte
// and one 4-byte shared-memory read.
// A sample's positions are staged in shared memory, up to 32 at a time,
// double-buffered: the next stage's global loads are issued into registers
// before the current stage is computed.  The per-sample norm is summed
// beside the products.  The masked dOut is mostly zero under ReLU6 masks
// (99.99% at layers 22 and 24 of a person_detect step, 85% at layer 26)
// and how much of it is zero drifts as a model trains, so the kernel's
// time would follow it: the staging marks, for each warp's 8 filters, the
// positions of the stage where one of them has a nonzero entry (one ballot
// and 8 shared atomics a warp of loads), and each warp computes those
// positions alone; a sample with none adds q = 0 to the warp's entries
// and takes no epilogue.  A row whose norm is 0 (an all-zero dOut column,
// or wrapped sums that cancel) takes no divide: its quotient is 0 or
// +-inf, which saturates; nor does a zero dividend, which would take the
// divide's slow path.  The thread's partial sums over its chunk go into
// acc_out by one atomic add an entry and block; acc_out starts as a copy
// of acc_in, made by a first small kernel on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTF = 64, kTC = 64;  // a block's tile: filters x channels
constexpr int kR = 4;              // a thread's tile: kR filters x kR channels
constexpr int kPC = 32;            // positions a stage holds
constexpr int kMinChunk = 8;       // fewest samples a block takes
constexpr int kWarps = kThreads / 32;  // a warp computes kR * 2 filters of the tile
constexpr int kVecs = kPC * (kTF / 4) / kThreads;  // 16-byte md loads a thread and stage
static_assert(kPC * (kTF / 4) % kThreads == 0, "whole loads");
static_assert(kPC <= 32, "a stage's positions fit a 32-bit mask");
static_assert(kTF / 4 == 16 && kTC / kR == 16, "a warp's loads cover two positions of the tile, "
              "and its computing lanes two rows of threads");

struct Stage {
  int md[kPC][kTF];
  int8_t x[kPC][kTC];
};

// round_away(y) (core/numerics.py::round_away), saturated to int8: y is
// finite; clamping first gives the same result, since the rounding is
// monotone and the rails are integers.
__device__ __forceinline__ int round_sat(float y) {
  y = fminf(fmaxf(y, -128.0f), 127.0f);
  const float t = truncf(y);
  const float r = fabsf(__fsub_rn(y, t)) >= 0.5f ? __fadd_rn(t, copysignf(1.0f, y)) : t;
  return __float2int_rz(r);
}

// The global loads of one stage: sample b, positions p0 .. p0 + np - 1, the
// block's tile; what lies outside the tensors reads 0.  kVec: F and C are
// multiples of 4 and md and x aligned to 16 and 4 bytes, so each load takes
// four values.
template <bool kVec>
struct Loads {
  int4 md[kVecs];
  int x[kVecs];

  __device__ __forceinline__ void load(const int* __restrict__ md_g,
                                       const int8_t* __restrict__ x_g, int b, int p0, int np,
                                       int P, int F, int C, int f0, int c0) {
#pragma unroll
    for (int k = 0; k < kVecs; k++) {
      const int i = threadIdx.x + k * kThreads;
      const int p = i / (kTF / 4), q = (i % (kTF / 4)) * 4;
      const long long row = (long long)b * P + p0 + p;
      const int f = f0 + q, c = c0 + q;
      int4 m = make_int4(0, 0, 0, 0);
      int w = 0;
      if (p < np) {
        if (kVec) {
          if (f < F) m = *reinterpret_cast<const int4*>(md_g + row * F + f);
          if (c < C) w = *reinterpret_cast<const int*>(x_g + row * C + c);
        } else {
          const int* mr = md_g + row * F;
          const int8_t* xr = x_g + row * C;
          m.x = f < F ? mr[f] : 0;
          m.y = f + 1 < F ? mr[f + 1] : 0;
          m.z = f + 2 < F ? mr[f + 2] : 0;
          m.w = f + 3 < F ? mr[f + 3] : 0;
#pragma unroll
          for (int j = 0; j < 4; j++)
            if (c + j < C) w |= ((int)(uint8_t)xr[c + j]) << (8 * j);
        }
      }
      md[k] = m;
      x[k] = w;
    }
  }

  // Stores the stage, and marks in live[w] each position at which the
  // filters of computing warp w have a nonzero dOut entry: a warp's loads
  // cover two positions (its half-warps) and every warp's filters, so one
  // ballot gives each computing warp's two bits, which lane w adds.
  __device__ __forceinline__ void store(Stage& s, unsigned* live) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < kVecs; k++) {
      const int i = threadIdx.x + k * kThreads;
      const int p = i / (kTF / 4), q = (i % (kTF / 4)) * 4;
      *reinterpret_cast<int4*>(&s.md[p][q]) = md[k];
      *reinterpret_cast<int*>(&s.x[p][q]) = x[k];
      const unsigned nz =
          __ballot_sync(0xffffffffu, (md[k].x | md[k].y | md[k].z | md[k].w) != 0);
      const unsigned two = ((nz >> (2 * lane)) & 3u ? 1u : 0u) |
                           ((nz >> (16 + 2 * lane)) & 3u ? 2u : 0u);
      const int p_even = (i - lane) / (kTF / 4);  // the warp's first position, even
      if (lane < kWarps && two) atomicOr(&live[lane], two << p_even);
    }
  }
};

__global__ void qwgrad_start(const int* __restrict__ acc_in, int* __restrict__ acc_out,
                             long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    acc_out[i] = acc_in[i];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    qwgrad_kernel(const int* __restrict__ md_g, const int8_t* __restrict__ x_g,
                  int* __restrict__ acc_out, int B, int P, int F, int C, int in_zp, int chunk) {
  __shared__ __align__(16) Stage stages[2];
  const int f0 = blockIdx.y * kTF, c0 = blockIdx.x * kTC;
  const int ty = threadIdx.x / (kTC / kR), tx = threadIdx.x % (kTC / kR);
  const int b0 = blockIdx.z * chunk;
  const int b1 = min(B, b0 + chunk);
  const int per_sample = (P + kPC - 1) / kPC;
  const int n_stages = (b1 - b0) * per_sample;

  unsigned part[kR][kR], dw[kR][kR], norm[kR];
#pragma unroll
  for (int i = 0; i < kR; i++) {
    norm[i] = 0u;
#pragma unroll
    for (int j = 0; j < kR; j++) part[i][j] = 0u, dw[i][j] = 0u;
  }

  // live[stage % 3][w]: the positions of a stage at which warp w's filters
  // have a nonzero dOut entry; the warp computes those alone, and a sample
  // with none adds q = 0 to its entries.  A slot is cleared two stages
  // ahead of its use, a barrier between each clearing and the next marks.
  __shared__ unsigned live[3][kWarps];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x < 3 * kWarps) (&live[0][0])[threadIdx.x] = 0u;
  __syncthreads();
  Loads<kVec> next;
  if (n_stages > 0) {
    next.load(md_g, x_g, b0, 0, min(P, kPC), P, F, C, f0, c0);
    next.store(stages[0], live[0]);
  }
  __syncthreads();
  bool sample_live = false;
  for (int s = 0; s < n_stages; s++) {
    const int p0 = (s % per_sample) * kPC;
    const int np = min(P - p0, kPC);
    if (threadIdx.x < kWarps) live[(s + 2) % 3][threadIdx.x] = 0u;
    if (s + 1 < n_stages) {
      const int b = b0 + (s + 1) / per_sample, q0 = ((s + 1) % per_sample) * kPC;
      next.load(md_g, x_g, b, q0, min(P - q0, kPC), P, F, C, f0, c0);
    }
    const Stage& st = stages[s & 1];
    unsigned bits = live[s % 3][warp];
    sample_live |= bits != 0u;
    while (bits) {
      const int p = __ffs(bits) - 1;
      bits &= bits - 1u;
      const int4 m4 = *reinterpret_cast<const int4*>(&st.md[p][ty * kR]);
      const int w = *reinterpret_cast<const int*>(&st.x[p][tx * kR]);
      const unsigned m[kR] = {(unsigned)m4.x, (unsigned)m4.y, (unsigned)m4.z, (unsigned)m4.w};
      unsigned xc[kR];
#pragma unroll
      for (int j = 0; j < kR; j++) xc[j] = (unsigned)((int)(int8_t)(w >> (8 * j)) - in_zp);
#pragma unroll
      for (int i = 0; i < kR; i++) {
        norm[i] += (int)m[i] < 0 ? 0u - m[i] : m[i];
#pragma unroll
        for (int j = 0; j < kR; j++) dw[i][j] += m[i] * xc[j];
      }
    }
    if (p0 + np == P && sample_live) {  // the sample's last stage: fold it in
#pragma unroll
      for (int i = 0; i < kR; i++) {
        const int n = (int)norm[i];
        if (n == 0) {
#pragma unroll
          for (int j = 0; j < kR; j++) {
            const int d = (int)dw[i][j];
            part[i][j] += (unsigned)(d > 0 ? 127 : (d < 0 ? -128 : 0));
          }
        } else {
          // 0 / n is 0: divide 1 instead, since a zero dividend takes the
          // IEEE divide's slow path
          const float fn = __int2float_rn(n);
#pragma unroll
          for (int j = 0; j < kR; j++) {
            const int d = (int)dw[i][j];
            const float y = __fdiv_rn(d == 0 ? 1.0f : __int2float_rn(d), fn);
            part[i][j] += d == 0 ? 0u : (unsigned)round_sat(y);
          }
        }
        norm[i] = 0u;
#pragma unroll
        for (int j = 0; j < kR; j++) dw[i][j] = 0u;
      }
    }
    if (p0 + np == P) sample_live = false;
    if (s + 1 < n_stages) next.store(stages[(s + 1) & 1], live[(s + 1) % 3]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kR; i++) {
    const int f = f0 + ty * kR + i;
#pragma unroll
    for (int j = 0; j < kR; j++) {
      const int c = c0 + tx * kR + j;
      if (f < F && c < C && part[i][j] != 0u)
        atomicAdd(reinterpret_cast<unsigned*>(acc_out) + (long long)f * C + c, part[i][j]);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <bool kVec>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, qwgrad_kernel<kVec>, kThreads, 0);
    if (blocks <= 0) blocks = 1;
  }
  return blocks;
}

template <bool kVec>
int launch(const int* md, const int8_t* x, int* acc_out, int B, int P, int F, int C, int in_zp,
           cudaStream_t stream) {
  const int tiles_c = (C + kTC - 1) / kTC, tiles_f = (F + kTF - 1) / kTF;
  // one wave: as many chunks of the batch as leave every tile's blocks
  // resident at once, each of at least kMinChunk samples
  const long long slots = (long long)sm_count() * resident_blocks<kVec>();
  long long chunks = slots / ((long long)tiles_c * tiles_f);
  if (chunks < 1) chunks = 1;
  int chunk = (int)((B + chunks - 1) / chunks);
  if (chunk < kMinChunk) chunk = kMinChunk;
  const int n_chunks = (B + chunk - 1) / chunk;
  if (tiles_f > 65535 || n_chunks > 65535) return (int)cudaErrorInvalidValue;
  qwgrad_kernel<kVec><<<dim3(tiles_c, tiles_f, n_chunks), kThreads, 0, stream>>>(
      md, x, acc_out, B, P, F, C, in_zp, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// acc_out[f, c] = acc_in[f, c] + sum_b q[b, f, c] (above) for md [B, P, F]
// int32, x [B, P, C] int8 and acc_in, acc_out [F, C] int32, all contiguous.
// vec: F and C are multiples of 4, md 16-byte and x 4-byte aligned.
extern "C" int mf_qwgrad(const void* md, const void* x, const void* acc_in, void* acc_out, int B,
                         int P, int F, int C, int in_zp, int vec, void* stream) {
  if (B < 0 || P < 1 || F < 1 || C < 1 || in_zp < -128 || in_zp > 127)
    return (int)cudaErrorInvalidValue;
  if (vec && (F % 4 || C % 4 || (uintptr_t)md % 16 || (uintptr_t)x % 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)F * C;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sm_count() * 8) blocks = (long long)sm_count() * 8;
  qwgrad_start<<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const int*>(acc_in),
                                                     static_cast<int*>(acc_out), n);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || B == 0) return rc;
  const auto* m = static_cast<const int*>(md);
  const auto* xs = static_cast<const int8_t*>(x);
  auto* out = static_cast<int*>(acc_out);
  return vec ? launch<true>(m, xs, out, B, P, F, C, in_zp, s)
             : launch<false>(m, xs, out, B, P, F, C, in_zp, s);
}
