// The int8 tensor-core instruction and the byte transpose that the kernels
// with an mma.sync path share: segment_ops.cuh (op_pw_mma, and op_dw_vec's
// tap words) for flatpack.cu, megakernel.cu and packed.cu, and qgemm.cu
// (qgemm_mma, which also builds its A fragments with transpose4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Transpose a 4x4 block of bytes: word j of t holds tap j's four channels;
// word c of w gets channel c's four taps, ready for __dp4a.
__device__ __forceinline__ void transpose4(const uint32_t (&t)[4], uint32_t (&w)[4]) {
  const uint32_t ab_lo = __byte_perm(t[0], t[1], 0x5140), ab_hi = __byte_perm(t[0], t[1], 0x7362);
  const uint32_t cd_lo = __byte_perm(t[2], t[3], 0x5140), cd_hi = __byte_perm(t[2], t[3], 0x7362);
  w[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  w[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  w[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  w[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// d += A (16x32 s8, row) x B (32x8 s8, col), s32 accumulators.  Lane l =
// 4g + t holds a = {row g k 4t..4t+3, row g+8 k 4t.., row g k 16+4t..,
// row g+8 k 16+4t..}, b = {k 4t..4t+3 of column g, k 16+4t.. of column g},
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

}  // namespace
