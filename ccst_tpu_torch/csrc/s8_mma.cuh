// Shared pieces of the int8 kernels (qconv3x3_s8.cu, level1_s8.cu,
// pool_conv_s8.cu, winograd_s8.cu): the mma.sync int8 instruction of the one
// route that still uses it (K0's 4-byte gather for Cin % 16 != 0), the edge
// index map and the float epilogue that reproduces
// ccst_tpu/models/vgg_fast.py::_qconv_s bit for bit.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ccst_s8 {

// D = A * B + D on int8 tensor cores, int32 accumulation. Fragments of
// mma.sync.m16n8k32 (PTX ISA, "Matrix fragments for mma.m16n8k32"), with
// g = lane / 4 and t = lane % 4:
//   a[0]: row g,   k 4t..4t+3     a[1]: row g+8, k 4t..4t+3
//   a[2]: row g,   k 16+4t..      a[3]: row g+8, k 16+4t..
//   b[0]: col g,   k 4t..4t+3     b[1]: col g,   k 16+4t..
//   c[0], c[1]: row g, cols 2t, 2t+1; c[2], c[3]: row g+8, cols 2t, 2t+1.
// Every operand register is four consecutive k of one row (A) or one column
// (B), so A is stored pixel-major and B output-channel-major, k contiguous.
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Index of edge-padded position i of an axis of length n.
__device__ __forceinline__ int edge_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// y = float(acc) * k + kb, rounded after the product and after the sum as the
// unfused XLA chain does: the explicit _rn intrinsics keep nvcc from
// contracting the two into one FMA, which would round once.
__device__ __forceinline__ float dequant(int acc, float k, float kb) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), k), kb);
}

// rint (half to even), clip to [lo, 127], int8: the requant of _qconv_s.
__device__ __forceinline__ int8_t requant(float y, float lo) {
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(rintf(y), lo), 127.0f)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = pred ? 16 : 0;  // 0 -> zero fill, no global read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

}  // namespace ccst_s8
