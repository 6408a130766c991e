// Tensor-core building blocks of `mma.sync` kernels (the tensor-core
// prefill takes the product and the quad reductions; the wgmma kernels
// take `pack` and the quad reductions, since a wgmma accumulator lays out
// its rows as mma.sync's does): warp-level `mma.sync.m16n8k16` products of
// bf16 with fp32 accumulators.
//
// In a warp, lane = 4 g + c: an accumulator fragment of a 16 x 8 tile holds
// rows g and g + 8, columns 2 c and 2 c + 1 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), so a row's values live in the 4 lanes of a quad and row
// reductions are 2 shuffles.

#pragma once

#include "flash_common.cuh"

namespace dstpu {
namespace flash {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// max / sum over the 4 lanes of a quad (the owners of one row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma
}  // namespace flash
}  // namespace dstpu
