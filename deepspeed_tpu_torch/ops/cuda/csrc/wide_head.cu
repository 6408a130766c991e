// Attention at head dims above 256 for Hopper (sm_90a): the five kernels'
// counterparts for every d > 256 with d % 8 == 0, in fp32 and bf16.
//
// Replaces, at those head dims, the TPU kernels the other sources replace at
// d <= 256: deepspeed_tpu/ops/pallas/flash_attention.py `_fwd_kernel`,
// `_dkdv_kernel`, `_dq_kernel` and deepspeed_tpu/ops/pallas/paged_attention.py
// `_kernel`, `_prefill_kernel`. The reference's Pallas kernels take any
// d % 8 == 0; the port's tiled kernels keep their whole head dim in shared
// memory or registers and stop at 256. No model of the repository has such a
// head dim, so these kernels aim at being right, not fast.
//
// Design. A CTA is 8 warps, and each warp owns one row: a query row (the
// forward, decode, prefill and dQ) or a key row (dK/dV). The row's own
// vectors (q, dO, k, v) and its fp32 accumulators sit in shared memory,
// [8][d] each, so nothing of the head dim lives in registers. The other
// side's rows stream through shared memory in tiles of 32 rows (one a lane)
// and 256 head dims at a time (`kChunk`), widened to fp32:
// - a dot product of the warp's row with row j of the tile is lane j's, summed
//   over the chunks (q . k, dO . v);
// - a product with the tile (p V, ds K, p dO, ds q) gives lane l the dims
//   8 l .. 8 l + 7 of each chunk, and each row's weight is broadcast from
//   its lane by a shuffle.
// Scores are fp32 with the reference's online softmax (l floored at 1e-30,
// masked scores -1e30); q is scaled before the dot in the forward kernels,
// as the Pallas kernels do, and the backward multiplies s and ds by the
// scale, as `_fa_bwd_xla` does. Shared memory grows as 8 rows x d x 4 B a
// vector: four of them in dK/dV at d = 1024 and two staged 32 x 256 tiles,
// 197 KB of a CTA's 227 KB. Above 1024 (`kSharedMaxD`) the row vectors move
// to the CTA's own slice of an fp32 workspace in global memory that the
// caller owns (`kSpill`; vecs x 8 x d floats a CTA), and only the staged
// tiles stay in shared memory: the same code over other addresses, so any
// head dim runs. Up to 1024 nothing changed.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kWarps;      // rows a CTA owns, one a warp
constexpr int kTile = 32;          // rows of a streamed tile, one a lane
constexpr int kChunk = 256;        // head dims of a streamed tile
constexpr int kLd = kChunk + 4;    // its shared row stride (floats): lanes' 16-byte loads
                                   // of rows j = 0..7 fall on distinct banks
constexpr int kSharedMaxD = 1024;  // above it the row vectors live in global memory
constexpr int kTileFloats = kTile * kLd;

struct Strides {
  long long b, s, h;
};

// Rows of a [B, S, H, D] tensor at a fixed batch and head: row i is at
// base + i * s.
struct StridedRows {
  long long s;
  template <typename T>
  __device__ __forceinline__ const T* operator()(const T* base, int i) const {
    return base + (long long)i * s;
  }
};

// Keys of one sequence in the paged pool [NB, BS, Hkv, D], at a fixed KV
// head: key i is row i % bs of block table[i / bs].
struct PagedRows {
  const int* table;
  int bs;
  long long key_stride;  // Hkv * D
  template <typename T>
  __device__ __forceinline__ const T* operator()(const T* base, int i) const {
    const int blk = i / bs;
    return base + ((long long)table[blk] * bs + (i - blk * bs)) * key_stride;
  }
};

// Stage dims c0 .. c0 + cw - 1 of rows r0 .. r0 + kTile - 1 (rows at or past
// n read as zeros, as do dims past cw) into a [kTile][kLd] fp32 tile.
template <typename T, typename Rows>
__device__ __forceinline__ void stage(float* dst, const T* base, Rows rows, int r0, int n,
                                      int c0, int cw) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PER_ROW = kChunk / VEC;
  for (int i = threadIdx.x; i < kTile * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * VEC;
    float f[VEC];
    if (r0 + r < n && c < cw) {
      dstpu::load16(rows(base, r0 + r) + c0 + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
    float* out = dst + r * kLd + c;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(out + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// Row w of a CTA's [kRows][d] shared vectors from global row `src` (null:
// zeros), each element times `mul`.
template <typename T>
__device__ __forceinline__ void load_row(float* dst, const T* src, int d, float mul) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < d; c += 32) dst[c] = src ? dstpu::to_float(src[c]) * mul : 0.f;
}

// lane j: the dot of the warp's shared row `x` (dims c0 ..) with row j of
// the staged tile, over cw dims
__device__ __forceinline__ float dot_tile(const float* x, const float* tile, int cw) {
  const float* t = tile + (threadIdx.x & 31) * kLd;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int c = 0; c < cw; c += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + c);
    const float4 tv = *reinterpret_cast<const float4*>(t + c);
    a0 = fmaf(xv.x, tv.x, a0);
    a1 = fmaf(xv.y, tv.y, a1);
    a2 = fmaf(xv.z, tv.z, a2);
    a3 = fmaf(xv.w, tv.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// acc[c0 + 8 lane + e] = acc[...] * corr + sum_j w_j tile[j][8 lane + e]
// for the dims below cw; w_j is lane j's `w`. Every lane takes part (the
// shuffles), whether or not it owns dims of this chunk.
__device__ __forceinline__ void axpy_tile(float* acc, const float* tile, int cw, float w,
                                          float corr) {
  const int lane = threadIdx.x & 31;
  const int c = 8 * lane;
  const bool own = c < cw;
  float a[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = own ? acc[c + e] * corr : 0.f;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float wj = __shfl_sync(0xffffffffu, w, j);
    if (own) {
      const float4 lo = *reinterpret_cast<const float4*>(tile + j * kLd + c);
      const float4 hi = *reinterpret_cast<const float4*>(tile + j * kLd + c + 4);
      a[0] = fmaf(wj, lo.x, a[0]);
      a[1] = fmaf(wj, lo.y, a[1]);
      a[2] = fmaf(wj, lo.z, a[2]);
      a[3] = fmaf(wj, lo.w, a[3]);
      a[4] = fmaf(wj, hi.x, a[4]);
      a[5] = fmaf(wj, hi.y, a[5]);
      a[6] = fmaf(wj, hi.z, a[6]);
      a[7] = fmaf(wj, hi.w, a[7]);
    }
  }
  if (own) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[c + e] = a[e];
  }
}

// Forward attention of the CTA's query rows: warp w's scaled q row is
// qs[w d ..], it sees keys 0 .. last (last < 0: none), and the CTA reads
// keys 0 .. n_keys - 1 (at least every row's last + 1). K row i is
// k_rows(k_base, i), V row i v_rows(v_base, i). Leaves the warp's
// unnormalised accumulator in acc[w d ..] and returns its m and l.
template <typename T, typename KRows, typename VRows>
__device__ __forceinline__ void attend(const float* qs, float* acc, float* tile, const T* k_base,
                                       KRows k_rows, const T* v_base, VRows v_rows, int d,
                                       int n_keys, int last, float& m, float& l) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* q = qs + w * d;
  float* a = acc + w * d;
  m = dstpu::kNegInf;
  l = 0.f;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    float s = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      const int cw = min(kChunk, d - c0);
      __syncthreads();  // the previous tile is consumed
      stage(tile, k_base, k_rows, k0, n_keys, c0, cw);
      __syncthreads();
      s += dot_tile(q + c0, tile, cw);
    }
    const bool seen = k0 + lane <= last;
    const float x = seen ? s : dstpu::kNegInf;
    const float m_new = fmaxf(m, dstpu::warp_max(x));
    const float p = seen ? expf(x - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + dstpu::warp_sum(p);
    m = m_new;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      const int cw = min(kChunk, d - c0);
      __syncthreads();
      stage(tile, v_base, v_rows, k0, n_keys, c0, cw);
      __syncthreads();
      axpy_tile(a + c0, tile, cw, p, corr);
    }
  }
}

// The CTA's row vectors, `vecs` [kRows][d] fp32 arrays: at the front of
// shared memory, or (kSpill) the CTA's slice of the caller's workspace.
template <bool kSpill>
__device__ __forceinline__ float* row_vectors(float* smem, float* spill, int vecs, int d) {
  if constexpr (kSpill) {
    const long long cta =
        blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
    return spill + cta * vecs * kRows * d;
  } else {
    return smem;
  }
}

// The staged tiles: shared memory past the row vectors, or all of it (kSpill).
template <bool kSpill>
__device__ __forceinline__ float* tile_space(float* smem, float* vectors_end) {
  if constexpr (kSpill) {
    return smem;
  } else {
    return vectors_end;
  }
}

// Before a lane reads a row's dims that other lanes of its warp wrote: in
// global memory (kSpill) the warp's order is not enough.
template <bool kSpill>
__device__ __forceinline__ void rows_written() {
  if constexpr (kSpill) __syncwarp();
}

// Write the warp's normalised output row (acc / max(l, 1e-30)) to `dst`.
template <typename T>
__device__ __forceinline__ void store_out(T* dst, const float* acc, int d, float l) {
  const int lane = threadIdx.x & 31;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int c = lane; c < d; c += 32) dst[c] = dstpu::from_float<T>(acc[c] * inv);
}

// ------------------------------------------------------------ flash forward
// grid (ceil(n_q / 8), hq, b); warp w: query row 8 blockIdx.x + w
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kThreads)
wide_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int hq, int hkv, int n_q, int n_kv, int d,
                      int causal, float scale, float* __restrict__ spill) {
  extern __shared__ __align__(16) float smem[];
  float* qs = row_vectors<kSpill>(smem, spill, 2, d);
  float* acc = qs + kRows * d;
  float* tile = tile_space<kSpill>(smem, acc + kRows * d);
  const int w = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + w;
  const bool live = i < n_q;
  const int hi = min(row0 + kRows, n_q) - 1;  // the CTA's last query row
  const int n_keys = causal ? min(n_kv, hi + 1) : n_kv;
  const int last = !live ? -1 : causal ? min(i, n_kv - 1) : n_kv - 1;
  load_row(qs + w * d, live ? q + b * sq.b + (long long)i * sq.s + h * sq.h : nullptr, d, scale);
  for (int c = threadIdx.x; c < kRows * d; c += kThreads) acc[c] = 0.f;
  __syncthreads();  // the rows and accumulators are in place
  float m, l;
  attend(qs, acc, tile, k + b * sk.b + hk * sk.h, StridedRows{sk.s}, v + b * sv.b + hk * sv.h,
         StridedRows{sv.s}, d, n_keys, last, m, l);
  if (!live) return;
  rows_written<kSpill>();
  store_out(o + b * so.b + (long long)i * so.s + h * so.h, acc + w * d, d, l);
  if ((threadIdx.x & 31) == 0)
    lse[((long long)b * hq + h) * n_q + i] = m + logf(fmaxf(l, 1e-30f));
}

// ------------------------------------------------------------- flash dQ
// grid (ceil(n_q / 8), hq, b); warp w: query row 8 blockIdx.x + w.
// dq = sum_j ds_j k_j, ds = p (dp - delta) scale, p = exp(s scale - lse).
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kThreads)
wide_flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdq, int hq, int hkv, int n_q, int n_kv,
                     int d, int causal, float scale, float* __restrict__ spill) {
  extern __shared__ __align__(16) float smem[];
  float* qs = row_vectors<kSpill>(smem, spill, 3, d);
  float* dos = qs + kRows * d;
  float* acc = dos + kRows * d;
  float* tile_a = tile_space<kSpill>(smem, acc + kRows * d);
  float* tile_b = tile_a + kTileFloats;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + w;
  const bool live = i < n_q;
  const int hi = min(row0 + kRows, n_q) - 1;
  const int n_keys = causal ? min(n_kv, hi + 1) : n_kv;
  const int last = !live ? -1 : causal ? min(i, n_kv - 1) : n_kv - 1;
  load_row(qs + w * d, live ? q + b * sq.b + (long long)i * sq.s + h * sq.h : nullptr, d, 1.f);
  load_row(dos + w * d, live ? dout + b * sdo.b + (long long)i * sdo.s + h * sdo.h : nullptr, d,
           1.f);
  for (int c = threadIdx.x; c < kRows * d; c += kThreads) acc[c] = 0.f;
  __syncthreads();  // the rows and accumulators are in place
  const long long vec = ((long long)b * hq + h) * n_q + i;
  const float lse_i = live ? lse[vec] : 0.f;
  const float delta_i = live ? delta[vec] : 0.f;
  const T* k_base = k + b * sk.b + hk * sk.h;
  const T* v_base = v + b * sv.b + hk * sv.h;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    float s = 0.f, dp = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      const int cw = min(kChunk, d - c0);
      __syncthreads();
      stage(tile_a, k_base, StridedRows{sk.s}, k0, n_keys, c0, cw);
      stage(tile_b, v_base, StridedRows{sv.s}, k0, n_keys, c0, cw);
      __syncthreads();
      s += dot_tile(qs + w * d + c0, tile_a, cw);
      dp += dot_tile(dos + w * d + c0, tile_b, cw);
    }
    const bool seen = k0 + lane <= last;
    const float p = seen ? expf(s * scale - lse_i) : 0.f;
    const float ds = p * (dp - delta_i) * scale;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      const int cw = min(kChunk, d - c0);
      __syncthreads();
      stage(tile_a, k_base, StridedRows{sk.s}, k0, n_keys, c0, cw);
      __syncthreads();
      axpy_tile(acc + w * d + c0, tile_a, cw, ds, 1.f);
    }
  }
  if (!live) return;
  rows_written<kSpill>();
  T* dst = dq + b * sdq.b + (long long)i * sdq.s + h * sdq.h;
  for (int c = lane; c < d; c += 32) dst[c] = dstpu::from_float<T>(acc[w * d + c]);
}

// ----------------------------------------------------------- flash dK/dV
// grid (ceil(n_kv / 8), hkv, b); warp w: key row 8 blockIdx.x + w, summed
// over the KV head's query heads and every query row that sees it.
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kThreads)
wide_flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
                       Strides sv, Strides sdo, Strides sdk, Strides sdv, int hq, int hkv,
                       int n_q, int n_kv, int d, int causal, float scale,
                       float* __restrict__ spill) {
  extern __shared__ __align__(16) float smem[];
  float* ks = row_vectors<kSpill>(smem, spill, 4, d);
  float* vs = ks + kRows * d;
  float* dk_acc = vs + kRows * d;
  float* dv_acc = dk_acc + kRows * d;
  float* tile_a = tile_space<kSpill>(smem, dv_acc + kRows * d);
  float* tile_b = tile_a + kTileFloats;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int key0 = blockIdx.x * kRows;
  const int kj = key0 + w;
  const bool live = kj < n_kv;
  load_row(ks + w * d, live ? k + b * sk.b + (long long)kj * sk.s + hk * sk.h : nullptr, d, 1.f);
  load_row(vs + w * d, live ? v + b * sv.b + (long long)kj * sv.s + hk * sv.h : nullptr, d, 1.f);
  for (int c = threadIdx.x; c < 2 * kRows * d; c += kThreads) dk_acc[c] = 0.f;  // dk, dv
  __syncthreads();
  // under the causal mask query row i sees key kj when kj <= i
  const int first = causal ? key0 / kTile * kTile : 0;
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const T* q_base = q + b * sq.b + h * sq.h;
    const T* do_base = dout + b * sdo.b + h * sdo.h;
    const float* lse_h = lse + ((long long)b * hq + h) * n_q;
    const float* delta_h = delta + ((long long)b * hq + h) * n_q;
    for (int i0 = first; i0 < n_q; i0 += kTile) {
      const int i = i0 + lane;
      float s = 0.f, dp = 0.f;
      for (int c0 = 0; c0 < d; c0 += kChunk) {
        const int cw = min(kChunk, d - c0);
        __syncthreads();
        stage(tile_a, q_base, StridedRows{sq.s}, i0, n_q, c0, cw);
        stage(tile_b, do_base, StridedRows{sdo.s}, i0, n_q, c0, cw);
        __syncthreads();
        s += dot_tile(ks + w * d + c0, tile_a, cw);
        dp += dot_tile(vs + w * d + c0, tile_b, cw);
      }
      const bool seen = live && i < n_q && (!causal || kj <= i);
      const float p = seen ? expf(s * scale - lse_h[i]) : 0.f;
      const float ds = seen ? p * (dp - delta_h[i]) * scale : 0.f;
      for (int c0 = 0; c0 < d; c0 += kChunk) {
        const int cw = min(kChunk, d - c0);
        __syncthreads();
        stage(tile_a, q_base, StridedRows{sq.s}, i0, n_q, c0, cw);
        stage(tile_b, do_base, StridedRows{sdo.s}, i0, n_q, c0, cw);
        __syncthreads();
        axpy_tile(dk_acc + w * d + c0, tile_a, cw, ds, 1.f);
        axpy_tile(dv_acc + w * d + c0, tile_b, cw, p, 1.f);
      }
    }
  }
  if (!live) return;
  rows_written<kSpill>();
  T* dkr = dk + b * sdk.b + (long long)kj * sdk.s + hk * sdk.h;
  T* dvr = dv + b * sdv.b + (long long)kj * sdv.s + hk * sdv.h;
  for (int c = lane; c < d; c += 32) {
    dkr[c] = dstpu::from_float<T>(dk_acc[w * d + c]);
    dvr[c] = dstpu::from_float<T>(dv_acc[w * d + c]);
  }
}

// ----------------------------------------------------------- paged decode
// grid (tokens, hkv, ceil(rep / 8)); warp w: query head hk rep + 8
// blockIdx.z + w of token t, which sees keys 0 .. positions[t] of the
// sequence in table row slots[t].
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kThreads)
wide_paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool, const int* __restrict__ slots,
                         const int* __restrict__ positions,
                         const int* __restrict__ block_tables, int bt_stride,
                         T* __restrict__ out, int hq, int hkv, int d, int bs, float scale,
                         float* __restrict__ spill) {
  extern __shared__ __align__(16) float smem[];
  float* qs = row_vectors<kSpill>(smem, spill, 2, d);
  float* acc = qs + kRows * d;
  float* tile = tile_space<kSpill>(smem, acc + kRows * d);
  const int w = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int hk = blockIdx.y;
  const int rep = hq / hkv;
  const int g = blockIdx.z * kRows + w;
  const bool live = g < rep;
  const long long row = (long long)t * hq + hk * rep + g;
  const int pos = positions[t];
  load_row(qs + w * d, live ? q + row * d : nullptr, d, scale);
  for (int c = threadIdx.x; c < kRows * d; c += kThreads) acc[c] = 0.f;
  __syncthreads();  // the rows and accumulators are in place
  const PagedRows rows{block_tables + (long long)slots[t] * bt_stride, bs, (long long)hkv * d};
  float m, l;
  attend(qs, acc, tile, k_pool + hk * d, rows, v_pool + hk * d, rows, d, pos + 1,
         live ? pos : -1, m, l);
  rows_written<kSpill>();
  if (live) store_out(out + row * d, acc + w * d, d, l);
}

// ---------------------------------------------------------- paged prefill
// grid (n_tiles * ceil(ct / 8), hq); warp w: row 8 g + w of tile c (blockIdx.x
// = c ceil(ct / 8) + g) at query head blockIdx.y. Row i of tile c sits at
// position tile_pos0[c] + i of the sequence in table row tile_slot[c]; rows
// at or past tile_valid[c] are padding and come out as zeros.
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kThreads)
wide_paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool, const int* __restrict__ tile_slot,
                          const int* __restrict__ tile_pos0, const int* __restrict__ tile_valid,
                          const int* __restrict__ block_tables, int bt_stride,
                          T* __restrict__ out, int hq, int hkv, int d, int bs, int ct,
                          float scale, float* __restrict__ spill) {
  extern __shared__ __align__(16) float smem[];
  float* qs = row_vectors<kSpill>(smem, spill, 2, d);
  float* acc = qs + kRows * d;
  float* tile = tile_space<kSpill>(smem, acc + kRows * d);
  const int w = threadIdx.x >> 5;
  const int groups = (ct + kRows - 1) / kRows;
  const int c = blockIdx.x / groups;
  const int i0 = (blockIdx.x - c * groups) * kRows;
  const int i = i0 + w;
  const int h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int valid = tile_valid[c];
  const int pos0 = tile_pos0[c];
  const bool row = i < ct;
  const bool live = row && i < valid;
  const long long qrow = ((long long)c * ct + i) * hq + h;
  const int n_keys = i0 < valid ? pos0 + min(valid, i0 + kRows) : 0;
  load_row(qs + w * d, live ? q + qrow * d : nullptr, d, scale);
  for (int x = threadIdx.x; x < kRows * d; x += kThreads) acc[x] = 0.f;
  __syncthreads();
  const PagedRows rows{block_tables + (long long)tile_slot[c] * bt_stride, bs,
                       (long long)hkv * d};
  float m, l;
  attend(qs, acc, tile, k_pool + hk * d, rows, v_pool + hk * d, rows, d, n_keys,
         live ? pos0 + i : -1, m, l);
  rows_written<kSpill>();
  if (row) store_out(out + qrow * d, acc + w * d, d, live ? l : 1.f);  // pad rows: acc is 0
}

// ------------------------------------------------------------------ launch
// shared floats: `vecs` [8][d] vectors (none when they live in global memory)
// and `tiles` staged tiles
inline bool spills(int d) { return d > kSharedMaxD; }

inline size_t smem_bytes(int d, int vecs, int tiles) {
  return sizeof(float) * ((size_t)(spills(d) ? 0 : vecs) * kRows * d + (size_t)tiles * kTileFloats);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return dstpu::allow_smem(kernel, smem);
}

// above kSharedMaxD the caller's workspace must hold the row vectors
inline bool bad(int d, const void* spill) { return d <= 256 || d % 8 || (spills(d) && !spill); }

inline Strides strides_at(const long long* s, int t) { return {s[3 * t], s[3 * t + 1], s[3 * t + 2]}; }

template <typename T>
cudaError_t flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                      const long long* st, int b, int n_q, int n_kv, int hq, int hkv, int d,
                      int causal, float scale, float* spill, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 2, 1);
  const auto kernel = spills(d) ? wide_flash_fwd_kernel<T, true> : wide_flash_fwd_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kRows - 1) / kRows, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), hq, hkv, n_q, n_kv, d, causal, scale, spill);
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, const long long* st, int b,
                     int n_q, int n_kv, int hq, int hkv, int d, int causal, float scale,
                     float* spill, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 3, 2);
  const auto kernel = spills(d) ? wide_flash_dq_kernel<T, true> : wide_flash_dq_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kRows - 1) / kRows, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), hq, hkv, n_q,
      n_kv, d, causal, scale, spill);
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_dkdv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const long long* st, int b, int n_q, int n_kv, int hq, int hkv, int d,
                       int causal, float scale, float* spill, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 4, 2);
  const auto kernel =
      spills(d) ? wide_flash_dkdv_kernel<T, true> : wide_flash_dkdv_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_kv + kRows - 1) / kRows, hkv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), hq, hkv, n_q, n_kv, d, causal, scale, spill);
  return cudaGetLastError();
}

template <typename T>
cudaError_t paged_decode(const void* q, const void* k_pool, const void* v_pool,
                         const void* slots, const void* positions, const void* block_tables,
                         int bt_stride, void* out, int n_tokens, int hq, int hkv, int d, int bs,
                         float scale, float* spill, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 2, 1);
  const auto kernel =
      spills(d) ? wide_paged_decode_kernel<T, true> : wide_paged_decode_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tokens, hkv, (hq / hkv + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(slots), static_cast<const int*>(positions),
      static_cast<const int*>(block_tables), bt_stride, static_cast<T*>(out), hq, hkv, d, bs,
      scale, spill);
  return cudaGetLastError();
}

template <typename T>
cudaError_t paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                          const void* tile_slot, const void* tile_pos0, const void* tile_valid,
                          const void* block_tables, int bt_stride, void* out, int n_tiles,
                          int hq, int hkv, int d, int bs, int ct, float scale, float* spill,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 2, 1);
  const auto kernel =
      spills(d) ? wide_paged_prefill_kernel<T, true> : wide_paged_prefill_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles * ((ct + kRows - 1) / kRows), hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tile_slot), static_cast<const int*>(tile_pos0),
      static_cast<const int*>(tile_valid), static_cast<const int*>(block_tables), bt_stride,
      static_cast<T*>(out), hq, hkv, d, bs, ct, scale, spill);
  return cudaGetLastError();
}

}  // namespace

// Every entry point: d a multiple of 8 above 256; dtype 0 = float32, 1 =
// bfloat16. `spill`: above 1024, the row vectors' fp32 workspace, vecs x 8 x
// d floats for each CTA of the launch (vecs: forward, decode and prefill 2,
// dQ 3, dK/dV 4); null up to 1024. Returns a cudaError_t (0 = launched).

// strides: element strides (batch, seq, head) of q, k, v, o in turn.
extern "C" int dstpu_wide_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const long long* strides, int b, int n_q,
                                    int n_kv, int hq, int hkv, int d, int causal, float scale,
                                    int dtype, int device, void* stream, void* spill) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad(d, spill)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(spill);
  if (dtype == 0)
    return (int)flash_fwd<float>(q, k, v, o, lse, strides, b, n_q, n_kv, hq, hkv, d, causal,
                                 scale, ws, s);
  if (dtype == 1)
    return (int)flash_fwd<__nv_bfloat16>(q, k, v, o, lse, strides, b, n_q, n_kv, hq, hkv, d,
                                         causal, scale, ws, s);
  return (int)cudaErrorInvalidValue;
}

// strides: q, k, v, dO, dK, dV in turn (18 values); lse, delta: fp32 [B, Hq, Sq].
extern "C" int dstpu_wide_flash_dkdv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, const long long* strides, int b,
                                     int n_q, int n_kv, int hq, int hkv, int d, int causal,
                                     float scale, int dtype, int device, void* stream,
                                     void* spill) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad(d, spill)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(spill);
  if (dtype == 0)
    return (int)flash_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, strides, b, n_q, n_kv, hq,
                                  hkv, d, causal, scale, ws, s);
  if (dtype == 1)
    return (int)flash_dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, strides, b, n_q,
                                          n_kv, hq, hkv, d, causal, scale, ws, s);
  return (int)cudaErrorInvalidValue;
}

// strides: q, k, v, dO, dQ in turn (15 values).
extern "C" int dstpu_wide_flash_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, const long long* strides, int b, int n_q, int n_kv,
                                   int hq, int hkv, int d, int causal, float scale, int dtype,
                                   int device, void* stream, void* spill) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad(d, spill)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(spill);
  if (dtype == 0)
    return (int)flash_dq<float>(q, k, v, dout, lse, delta, dq, strides, b, n_q, n_kv, hq, hkv,
                                d, causal, scale, ws, s);
  if (dtype == 1)
    return (int)flash_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, strides, b, n_q, n_kv,
                                        hq, hkv, d, causal, scale, ws, s);
  return (int)cudaErrorInvalidValue;
}

// q, out [T, Hq, D] and pools [NB, BS, Hkv, D] contiguous.
extern "C" int dstpu_wide_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                       const void* slots, const void* positions,
                                       const void* block_tables, int bt_stride, void* out,
                                       int n_tokens, int hq, int hkv, int d, int bs, float scale,
                                       int dtype, int device, void* stream, void* spill) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad(d, spill)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(spill);
  if (dtype == 0)
    return (int)paged_decode<float>(q, k_pool, v_pool, slots, positions, block_tables,
                                    bt_stride, out, n_tokens, hq, hkv, d, bs, scale, ws, s);
  if (dtype == 1)
    return (int)paged_decode<__nv_bfloat16>(q, k_pool, v_pool, slots, positions, block_tables,
                                            bt_stride, out, n_tokens, hq, hkv, d, bs, scale, ws,
                                            s);
  return (int)cudaErrorInvalidValue;
}

// q, out [NT * CT, Hq, D] and pools [NB, BS, Hkv, D] contiguous.
extern "C" int dstpu_wide_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                                        const void* tile_slot, const void* tile_pos0,
                                        const void* tile_valid, const void* block_tables,
                                        int bt_stride, void* out, int n_tiles, int hq, int hkv,
                                        int d, int bs, int ct, float scale, int dtype,
                                        int device, void* stream, void* spill) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad(d, spill)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(spill);
  if (dtype == 0)
    return (int)paged_prefill<float>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid,
                                     block_tables, bt_stride, out, n_tiles, hq, hkv, d, bs, ct,
                                     scale, ws, s);
  if (dtype == 1)
    return (int)paged_prefill<__nv_bfloat16>(q, k_pool, v_pool, tile_slot, tile_pos0,
                                             tile_valid, block_tables, bt_stride, out, n_tiles,
                                             hq, hkv, d, bs, ct, scale, ws, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared bytes of each kernel at head dim d (0 = flash forward, 1 =
// dK/dV, 2 = dQ, 3 = paged decode, 4 = paged prefill)
extern "C" size_t dstpu_wide_smem_bytes(int kernel, int d) {
  switch (kernel) {
    case 1: return smem_bytes(d, 4, 2);
    case 2: return smem_bytes(d, 3, 2);
    default: return smem_bytes(d, 2, 1);
  }
}
