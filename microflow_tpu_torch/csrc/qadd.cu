// Quantized elementwise ADD of two int8 tensors of one shape for Hopper
// (sm_90a), bit-equal to TFLite's integer ADD
// (tensorflow/lite/kernels/internal/reference/integer_ops/add.h):
//
//   a   = (x1 - in1_zp) << left_shift,  b = (x2 - in2_zp) << left_shift
//   s   = scale(a, m1, e1) + scale(b, m2, e2)
//   out = clamp(scale(s, mo, eo) + out_zp, lo, hi) as int8
//
// scale(v, m, e) is gemmlowp's RoundingDivideByPOT(
// SaturatingRoundingDoublingHighMul(v, m), -e): the high word of 2*v*m,
// rounded half away from zero, then a right shift by -e rounded half away
// from zero.  The constants come from the model's fold
// (compiler/folding.py::preprocess_add).
//
// What bounds it on an H100: bytes.  Each element reads two bytes and writes
// one, with no reuse.  The arithmetic would come close to the bound (three
// 64-bit products and three rounding shifts an element), so each block first
// tabulates scale((x - zp) << left_shift, m, e) for the 256 codes of each
// input in shared memory: an element then costs two table reads, an add and
// the output's one product and shift.  A thread takes 16 elements a step
// through 16-byte loads and stores where all three tensors are 16-byte
// aligned (the wrapper says so), the rest one byte at a time; a grid-stride
// loop over a grid sized to the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct AddConsts {
  int in1_zp, in2_zp, out_zp, left_shift, m1, e1, m2, e2, mo, eo, lo, hi;
};

// gemmlowp's SaturatingRoundingDoublingHighMul; m > 0, so it never saturates.
__device__ __forceinline__ int high_mul(int v, int m) {
  const long long ab = (long long)v * (long long)m;
  const long long nudge = ab >= 0 ? (1LL << 30) : (1LL - (1LL << 30));
  return (int)((ab + nudge) / (1LL << 31));  // truncates toward zero, as C++ does
}

// gemmlowp's RoundingDivideByPOT, 0 <= e <= 31.
__device__ __forceinline__ int rounding_shift(int v, int e) {
  const int mask = (int)((1LL << e) - 1);
  const int threshold = (mask >> 1) + (v < 0 ? 1 : 0);
  return (v >> e) + ((v & mask) > threshold ? 1 : 0);
}

__device__ __forceinline__ int scale(int v, int m, int shift) {
  return rounding_shift(high_mul(v, m), -shift);
}

__device__ __forceinline__ int add_one(int x1, int x2, const int* t1, const int* t2,
                                       const AddConsts& c) {
  const int s = t1[x1 + 128] + t2[x2 + 128];
  const int y = scale(s, c.mo, c.eo) + c.out_zp;
  return min(max(y, c.lo), c.hi);
}

// Four int8 lanes of a word.
__device__ __forceinline__ unsigned add_word(unsigned w1, unsigned w2, const int* t1,
                                             const int* t2, const AddConsts& c) {
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const int x1 = (int)(int8_t)(w1 >> (8 * k));
    const int x2 = (int)(int8_t)(w2 >> (8 * k));
    out |= ((unsigned)add_one(x1, x2, t1, t2, c) & 0xffu) << (8 * k);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads) qadd_kernel(const int8_t* __restrict__ a,
                                                         const int8_t* __restrict__ b,
                                                         int8_t* __restrict__ out, long long n,
                                                         long long n16, AddConsts c) {
  __shared__ int t1[256], t2[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int x = i - 128;
    t1[i] = scale((x - c.in1_zp) * (1 << c.left_shift), c.m1, c.e1);
    t2[i] = scale((x - c.in2_zp) * (1 << c.left_shift), c.m2, c.e2);
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const auto* va = reinterpret_cast<const uint4*>(a);
  const auto* vb = reinterpret_cast<const uint4*>(b);
  auto* vo = reinterpret_cast<uint4*>(out);
  for (long long i = first; i < n16; i += stride) {
    const uint4 p = va[i], q = vb[i];
    uint4 r;
    r.x = add_word(p.x, q.x, t1, t2, c);
    r.y = add_word(p.y, q.y, t1, t2, c);
    r.z = add_word(p.z, q.z, t1, t2, c);
    r.w = add_word(p.w, q.w, t1, t2, c);
    vo[i] = r;
  }
  for (long long i = n16 * 16 + first; i < n; i += stride)
    out[i] = (int8_t)add_one(a[i], b[i], t1, t2, c);
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

}  // namespace

// out[i] = ADD(a[i], b[i]) for n int8 elements.  vec: all three pointers are
// 16-byte aligned, so the kernel may take 16 elements a load.
extern "C" int mf_qadd(const void* a, const void* b, void* out, long long n, int in1_zp,
                       int in2_zp, int out_zp, int left_shift, int m1, int e1, int m2, int e2,
                       int mo, int eo, int lo, int hi, int vec, void* stream) {
  if (n < 0 || left_shift < 0 || left_shift > 20 || e1 > 0 || e2 > 0 || eo > 0 || e1 < -31 ||
      e2 < -31 || eo < -31 || m1 < 0 || m2 < 0 || mo < 0 || lo > hi || lo < -128 || hi > 127)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (vec && ((uintptr_t)a % 16 || (uintptr_t)b % 16 || (uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  const long long n16 = vec ? n / 16 : 0;
  const long long work = n16 + (n - n16 * 16);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  AddConsts c{in1_zp, in2_zp, out_zp, left_shift, m1, e1, m2, e2, mo, eo, lo, hi};
  qadd_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int8_t*>(out),
      n, n16, c);
  return (int)cudaGetLastError();
}
