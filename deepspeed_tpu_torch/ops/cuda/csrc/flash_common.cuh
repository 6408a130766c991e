// Shared core of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// 64-row tiles of q, k, v and dO staged in shared memory as fp32, and two
// register-tiled products over them on the CUDA cores. These kernels serve
// fp32 at every head dim and bf16 at the head dims the wgmma kernels do not
// take. They are compiled for padded head dims D in {64, 128, 256}: a head
// dim d <= D is read zero-filled past d (a zero column adds nothing to a
// dot) and written masked to d, and the caller's softmax scale is 1 /
// sqrt(d), never the bucket's. Where four 64-row D = 256 tiles do not fit
// in shared memory, the backward kernels take 32-row tiles of the operand
// they loop over.
//
// Layout: q, o, dO [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D], read through
// their element strides (batch, sequence, head; the head dim is contiguous),
// so the model's [B, S, H, D] tensors need no transposing copy. lse and
// delta are contiguous fp32 [B, Hq, Sq].
//
// A CTA is 256 threads, a 16 x 16 grid (ty, tx). In every product a thread
// owns the 4 rows ty + 16 i of its left operand, so a row's 16 owners are
// the 16 lanes of one half-warp: row reductions are 4 shuffles, and a row
// of probabilities written to shared memory is read back only by the
// half-warp that wrote it (a __syncwarp, not a __syncthreads). Shared rows
// are D + 4 floats apart, which keeps the 16-byte loads of neighbouring
// lanes (rows tx + 16 j, or columns tx * 4) on distinct bank groups.

#pragma once

#include "common.cuh"

namespace dstpu {
namespace flash {

constexpr int kBlock = 64;     // rows of a q tile and of a kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding after each shared row
constexpr int kLP = kBlock + kPad;  // row stride of a [64][64] score tile

// Element strides of a [B, S, H, D] tensor whose head dim is contiguous.
struct Strides {
  long long b, s, h;
};

// How many `keys`-key tiles, counted from key 0, the rows [row0, row0 +
// rows) that lie below n_q see: every tile, or under the causal mask those
// up to the last such row's position (0 if no row lies below n_q).
__device__ __forceinline__ int key_tiles(int row0, int rows, int n_q, int n_kv, int causal,
                                         int keys) {
  const int n = (n_kv + keys - 1) / keys;
  const int last = min(row0 + rows, n_q) - 1;
  if (last < row0) return 0;
  return causal ? min(n, last / keys + 1) : n;
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// Stage rows row0 .. row0 + ROWS - 1 of head h, batch b into a shared
// [ROWS][D + kPad] fp32 tile, each element times `mul`; rows at or past
// n_rows and columns at or past d are zeros.
template <typename T, int D, int ROWS = kBlock>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, Strides st,
                                          int b, int h, int row0, int n_rows, int d, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * VEC;
    float f[VEC];
    if (row0 + r < n_rows && c < d) {
      load16(base + (long long)(row0 + r) * st.s + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
    float* out = dst + r * (D + kPad) + c;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(out + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
  }
}

// ROWS entries of a contiguous fp32 row vector (lse or delta); zeros past n.
template <int ROWS = kBlock>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int n) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads)
    dst[i] = row0 + i < n ? src[row0 + i] : 0.f;
}

// c[i][j] = sum_{x < N} A[(ty + 16 i) * lda + x] * B[(tx + 16 j) * ldb + x]:
// a (16 I) x (16 J) tile of A B^T, both operands row-major in shared memory.
template <int N, int I = 4, int J = 4>
__device__ __forceinline__ void tile_nt(float (&c)[I][J], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int x = 0; x < N; x += 4) {
    float4 a[I], bv[J];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + x);
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ldb + x);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float t = c[i][j];
        t = fmaf(a[i].x, bv[j].x, t);
        t = fmaf(a[i].y, bv[j].y, t);
        t = fmaf(a[i].z, bv[j].z, t);
        t = fmaf(a[i].w, bv[j].w, t);
        c[i][j] = t;
      }
  }
}

// c[i][g * 4 + e] += sum_{y < N} A[(ty + 16 i) * lda + y] * B[y * ldb + g * 64 + tx * 4 + e]:
// a 64 x (64 G) tile of A B, A row-major (its rows are probabilities or
// score gradients), B row-major (v, dO, q or k rows).
template <int N, int G>
__device__ __forceinline__ void tile_nn(float (&c)[4][4 * G], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 2
  for (int y = 0; y < N; y += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + y);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 bv = *reinterpret_cast<const float4*>(B + (y + u) * ldb + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = comp(a[i], u);
          c[i][g * 4 + 0] = fmaf(av, bv.x, c[i][g * 4 + 0]);
          c[i][g * 4 + 1] = fmaf(av, bv.y, c[i][g * 4 + 1]);
          c[i][g * 4 + 2] = fmaf(av, bv.z, c[i][g * 4 + 2]);
          c[i][g * 4 + 3] = fmaf(av, bv.w, c[i][g * 4 + 3]);
        }
      }
    }
  }
}

// max / sum over the 16 lanes of a half-warp (the owners of one row)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Write the thread's 4 x (4 G) accumulator tile, rows row0 + ty + 16 i of
// head h of [B, S, H, D] `dst`, times `mul`; rows at or past n_rows and
// columns at or past d (a multiple of 4) are skipped.
template <typename T, int G>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, Strides st, int b, int h,
                                           int row0, int n_rows, int d,
                                           const float (&c)[4][4 * G], const float (&mul)[4],
                                           int ty, int tx) {
  T* base = dst + b * st.b + h * st.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n_rows) continue;
    T* row = base + (long long)r * st.s;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g * 64 + tx * 4 >= d) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) row[g * 64 + tx * 4 + e] = from_float<T>(c[i][g * 4 + e] * mul[i]);
    }
  }
}

// Shared bytes of a kernel staging `rows` rows of [.][D + kPad] tiles in
// all, `score_rows` rows of [.][cols + kPad] score tiles and `vecs` floats
// of row vectors (lse, delta).
__host__ __device__ constexpr size_t smem_bytes(int d, int rows, int score_rows, int cols,
                                                int vecs) {
  return sizeof(float) * ((size_t)rows * (d + kPad) + (size_t)score_rows * (cols + kPad) +
                          (size_t)vecs);
}

// The padded head dim a CUDA-core kernel is compiled for: 64, 128 or 256.
__host__ __device__ constexpr int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace flash
}  // namespace dstpu
