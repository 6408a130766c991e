// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): bf16 tiles in shared memory and warp-level
// `mma.sync.m16n8k16` products with fp32 accumulators.
//
// A CTA is 4 warps; warp w owns rows 16 w .. 16 w + 15 of a 64-row tile. In
// a warp, lane = 4 g + c: an accumulator fragment of a 16 x 8 tile holds
// rows g and g + 8, columns 2 c and 2 c + 1 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), so a row's values live in the 4 lanes of a quad and row
// reductions are 2 shuffles. The scores of a 16 x 64 tile (8 fragments)
// become, packed to bf16, the A operand of the next product without
// leaving registers.
//
// Shared tiles are row-major with rows D + 8 (or 64 + 8) bf16 apart: the
// 32-bit fragment loads of the 32 lanes (rows g, words c) then hit 32
// distinct banks. An operand the next product needs with its other index
// contiguous (v, k, q, dO) is also staged transposed.

#pragma once

#include "flash_common.cuh"

namespace dstpu {
namespace flash {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadH = 8;              // bf16 of padding after each shared row
constexpr int kLT = kBlock + kPadH;   // row stride of a transposed [D][64] tile

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows row0 .. row0 + 63 of head h, batch b of a [B, S, H, D] tensor into a
// shared [64][D + kPadH] tile; rows at or past n_rows are zeros.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, Strides st,
                                           int b, int h, int row0, int n_rows) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks
  const bf16* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kBlock * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * st.s + c));
    *reinterpret_cast<uint4*>(dst + r * (D + kPadH) + c) = v;
  }
}

// The same rows transposed: shared [D][64 + kPadH], element (d, r). Lanes
// take neighbouring rows, so their 2-byte stores land in neighbouring
// words.
template <int D>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src, Strides st,
                                           int b, int h, int row0, int n_rows) {
  const bf16* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kBlock * (D / 8); i += kThreads) {
    const int r = i % kBlock;
    const int c = (i / kBlock) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * st.s + c));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLT + r] = e[j];
  }
}

// s[j] = A[r0 .. r0+15][0 .. K) . B[8 j .. 8 j + 7][0 .. K)^T for j < 8: a
// 16 x 64 tile of A B^T, both operands row-major in shared memory.
template <int K>
__device__ __forceinline__ void warp_nt(float (&s)[8][4], const bf16* A, int lda, int r0,
                                        const bf16* B, int ldb, int g, int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* pa = A + (r0 + g) * lda + k0 + 2 * c;
    const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * lda), ld32(pa + 8), ld32(pa + 8 * lda + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* pb = B + (8 * j + g) * ldb + k0 + 2 * c;
      mma16816(s[j], a, ld32(pb), ld32(pb + 8));
    }
  }
}

// The A fragments (16 rows x 64, four k-steps of 16) of a score tile s.
__device__ __forceinline__ void to_a(uint32_t (&pa)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    pa[t][0] = pack(s[2 * t][0], s[2 * t][1]);
    pa[t][1] = pack(s[2 * t][2], s[2 * t][3]);
    pa[t][2] = pack(s[2 * t + 1][0], s[2 * t + 1][1]);
    pa[t][3] = pack(s[2 * t + 1][2], s[2 * t + 1][3]);
  }
}

// acc[n] += P . Bt^T over 64 k: P the 16 x 64 A fragments, Bt a transposed
// shared tile [D][64 + kPadH] (n = head dim, k contiguous); NT = D / 8.
template <int NT>
__device__ __forceinline__ void warp_pv(float (&acc)[NT][4], const uint32_t (&pa)[4][4],
                                        const bf16* Bt, int g, int c) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* pb = Bt + (8 * n + g) * kLT + 16 * t + 2 * c;
      mma16816(acc[n], pa[t], ld32(pb), ld32(pb + 8));
    }
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

// Write a warp's 16 x D accumulator (rows row0 + g and row0 + g + 8 of head
// h), each row times mul[0] or mul[1]; rows at or past n_rows are skipped.
template <int NT>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, Strides st, int b, int h,
                                          int row0, int n_rows, const float (&acc)[NT][4],
                                          const float (&mul)[2], int g, int c) {
  bf16* base = dst + b * st.b + h * st.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= n_rows) continue;
    bf16* row = base + (long long)r * st.s + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * half] * mul[half], acc[n][2 * half + 1] * mul[half]);
  }
}

// Shared bytes of a kernel staging `rows` [64][D + 8] and `cols` [D][72]
// bf16 tiles and `vecs` 64-float row vectors.
__host__ __device__ constexpr size_t smem_bytes(int d, int rows, int cols, int vecs) {
  return sizeof(bf16) * ((size_t)rows * kBlock * (d + kPadH) + (size_t)cols * d * kLT) +
         sizeof(float) * (size_t)vecs * kBlock;
}

}  // namespace mma
}  // namespace flash
}  // namespace dstpu
