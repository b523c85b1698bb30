// Packed-pipeline kernel for Hopper (sm_90a): backend "packed".
//
// Replaces the Pallas kernel microflow_tpu/kernels/packed.py::build_packed_kernel
// (body `kernel`, launcher `packed_fn`): the depthwise/pointwise prefix of a
// MobileNet-style graph in one launch, int8 [B, H, W] -> int8
// [B, h_out, w_out * c_out].  The plan is the flat kernel's descriptor
// layout for the prefix's layers (kernels/packed.py::device_ops, written by
// kernels/flatpack.py::pack_plan with every op's F_EXACT = R_EXACT), one
// device buffer made once per model.
//
// What bounds it on an H100: operations.  person_detect's prefix (layers
// 0-22) does 6.24M multiply-adds per sample on 9,216 input bytes and 4,608
// output bytes, so at batch 8192 the int8 tensor-core peak allows 0.052 ms
// and HBM 0.034 ms.  The TPU kernel held each activation as rows of W*C
// lanes between two guard rows of the zero point, with per-lane planes,
// for its (8, 128) tiles; none of that is carried over.  The card keeps
// every intermediate tensor of a sample on chip in the persistent block
// loop of segment_ops.cuh (run_plan; 36,864 + 18,432 bytes of shared
// memory for person_detect, four blocks an SM), tensors [H][W][C] with no
// guard rows, and runs each op on the path the plan marks: the 3x3
// depthwise convs and the 3x3/s2 stem in register-held strips (F_DW3:
// op_dw3<1|2>, op_dw3_stem; all 12 of person_detect's prefix), the 1x1
// convs with a multiple of 16 output channels on the int8 tensor cores
// (F_MMA: op_pw_mma; all 11), other depthwise convs over a multiple of 4
// channels four channels a thread (F_VEC: op_dw_vec), and what those
// paths refuse by shape on the general paths of general_ops.cuh (a
// depthwise conv or a 1x1 conv over 1 or 2 channels, a 1x1 conv to fewer
// than 16).  The strips test a row once per strip row where the TPU kernel
// read a guard row, and a tap outside the input reads in_zp, removed again
// by the per-channel d; the general paths skip it.  Either way the sum is
// over in-bounds taps (x - in_zp) * w, the plain version's function.
//
// Requant: y = bias0 + c1 * f32(acc) with the multiply and the add rounded
// apart, then roundf and the clip (csrc/epilogue.cuh, -fmad=false), as the
// JAX kernel's lax.round(..., AWAY_FROM_ZERO).

#include "segment_ops.cuh"
#include "general_ops.cuh"

namespace {

enum { K_DW, K_CONV, K_PW };  // kernels/flatpack.py::KINDS

__global__ void __launch_bounds__(kThreads, 4)
    packed_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long B,
                  const unsigned char* __restrict__ plan, int n_ops, int in_elems, int out_elems,
                  int smem_a) {
  run_plan(x, out, B, plan, n_ops, in_elems, out_elems, smem_a,
           [](const Op& op, const int8_t* src, int8_t* dst) {
             switch (op[F_KIND]) {
               case K_DW:
                 switch (op[F_DW3]) {
                   case DW3_S1: op_dw3<1>(op, src, dst); break;
                   case DW3_S2: op_dw3<2>(op, src, dst); break;
                   case DW3_STEM: op_dw3_stem(op, src, dst); break;
                   default:
                     if (op[F_VEC]) op_dw_vec(op, src, dst);
                     else op_dw(op, src, dst);
                 }
                 break;
               case K_PW:
                 if (op[F_MMA]) op_pw_mma(op, src, dst);
                 else op_pw(op, src, dst);
                 break;
               default: op_conv(op, src, dst); break;
             }
           });
}

// What the kernel's reads assume of a plan, checked on the host copy of
// its descriptors: every op is a depthwise conv, a Conv2D or a 1x1 conv
// that rounds half away from zero, reads and writes inside its
// shared-memory buffer (16-byte multiples) and takes the tensor the op
// before it wrote; a 1x1 conv reads whole words of pixels inside its input
// and its 16-byte weight words aligned; the shared paths' own assumptions
// hold (shared_path_ok); the last tensor is out_elems long.
bool plan_ok(const int* desc, const void* plan, int n_ops, int in_elems, int out_elems,
             int smem_a, int smem_b) {
  if (smem_a % 16 || smem_b % 16 || reinterpret_cast<uintptr_t>(plan) % 16 || in_elems > smem_b)
    return false;
  long long cur = in_elems;
  for (int o = 0; o < n_ops; ++o) {
    const int* f = desc + o * NF;
    const int kind = f[F_KIND], ic = f[F_IC];
    const long long n_in = f[F_IN], n_out = f[F_OUT];
    if (kind < K_DW || kind > K_PW || f[F_EXACT] != R_EXACT || n_in != cur || n_out <= 0 ||
        n_out > ((o & 1) ? smem_b : smem_a))
      return false;
    if ((long long)f[F_IH] * f[F_IW] * ic != n_in ||
        (long long)f[F_OH] * f[F_OW] * f[F_OC] != n_out)
      return false;
    if (kind == K_PW && (ic % 4 || f[F_W] % 16 || (f[F_OH] - 1) * f[F_SR] >= f[F_IH] ||
                         (f[F_OW] - 1) * f[F_SC] >= f[F_IW]))
      return false;
    if (!shared_path_ok(f, K_DW, K_PW)) return false;
    cur = n_out;
  }
  return cur == out_elems;
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: int8 [B, in_elems]; plan:
// the device buffer of kernels/packed.py's plan; desc: a host copy of its
// first n_ops descriptors, which the entry point checks (plan_ok) and
// refuses the launch with cudaErrorInvalidValue if a read would not hold;
// smem_a/smem_b: its two buffer sizes.  Persistent blocks (launch_plan).
// Returns the CUDA error code (0 on success); a launch the card refuses
// returns its error here.
extern "C" int mf_packed(const void* x, void* out, long long B, const void* plan,
                         const int* desc, int n_ops, int in_elems, int out_elems, int smem_a,
                         int smem_b, void* stream) {
  if (B <= 0 || n_ops <= 0 || in_elems <= 0 || out_elems <= 0 ||
      !plan_ok(desc, plan, n_ops, in_elems, out_elems, smem_a, smem_b))
    return (int)cudaErrorInvalidValue;
  return launch_plan(packed_kernel, x, out, B, plan, n_ops, in_elems, out_elems, smem_a, smem_b,
                     stream);
}
