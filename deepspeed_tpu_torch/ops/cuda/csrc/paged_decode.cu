// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py:37
// `_kernel` (reached through `paged_decode_attention`): every ragged token
// attends over its own sequence's KV blocks, read through
// block_tables[slots[t], j], keys masked to kpos <= pos, GQA grouped by KV
// head. Same arithmetic as the Pallas kernel: q is scaled before the dot,
// the softmax is an fp32 online softmax with l floored at 1e-30, and the
// output is rounded once, at the end. Padding tokens (slot max_seqs, an
// all-zero table row, position 0) attend scratch block 0 and are harmless.
//
// What bounds it on the H100: bytes. Each token reads its context's K and V
// once (bf16: 2 x 128 x 2 B a key and KV head) and does 4 flops a key,
// query head and head dim: at GQA rep 4 about 4 flops a byte, far below
// the card's ridge. The CUDA cores suffice; the design is about keeping
// enough copies in flight to keep HBM busy.
//
// Design (flash-decoding). The TPU kernel runs a sequential (token, block)
// grid and carries its softmax state in VMEM from step to step. Here the
// grid is (token, KV head, split), and split s owns the blocks [s bps,
// (s + 1) bps) of its token's context. The host picks bps from the token
// count, the KV heads, the SM count and the table's width, never from the
// positions, so the launch reads nothing back and a CUDA graph can capture
// it. A split that starts past its token's last block exits at once.
// - A CTA (4 warps) reads its block ids from the table once, never an entry
//   past the token's last block (freed rows and stale ids live there), and
//   streams steps of 32 keys (16 at fp32 and d > 128) of K and V through a
//   3-stage ring of 16-byte cp.async copies, kept in the pool's dtype: the
//   copies of steps j + 1 and j + 2 are in flight while step j is scored.
//   Keys past the token's position are not read.
// - Warp w owns the query heads w RPW .. w RPW + RPW - 1 of the KV head's
//   GQA group; their scaled q rows sit in shared memory as fp32. Scores:
//   lane k takes key k of the step, widens its row to fp32 in registers and
//   dots it with the warp's rows (shared rows are padded by 16 bytes, so the
//   lanes' 16-byte loads of 32 rows hit distinct banks). P V: lane l holds
//   dims l E .. l E + E - 1 (E = DP / 32) of the rows' accumulators; each
//   key's probability is broadcast by a shuffle and its V row read once.
// - Combine: a token whose context lies in one split gets its output
//   written directly. Otherwise each live split writes fp32 partials (m, l,
//   acc[d]) of its query heads to a workspace and counts itself on the
//   (token, KV head)'s counter; the last to arrive merges the partials in
//   split order (acc = sum_s acc_s exp(m_s - m), l likewise), writes the
//   output and resets the counter to 0. The merge order is fixed, so two
//   launches on the same inputs give the same bits. The merge keeps nothing
//   in shared memory: each thread takes 4 dims of a row and reads the row's
//   m and l from L2 itself, so shared memory does not grow with the splits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;

// Layout of an instance: dtype T, head dim padded to DP (64, 128, 256).
template <typename T, int DP>
struct Shape {
  static constexpr int kRowBytes = DP * (int)sizeof(T);   // a K or V row
  static constexpr int kLd = kRowBytes + 16;               // its stride in shared memory
  static constexpr int kChunks = kRowBytes / 16;           // 16-byte chunks of a row
  static constexpr int kVec = 16 / (int)sizeof(T);         // elements of a chunk
  static constexpr int kKeys = kRowBytes > 512 ? 16 : 32;  // keys of a ring step
  static constexpr int kStage = 2 * kKeys * kLd;           // a step's K rows, then its V rows
  static constexpr int kPerLane = DP / 32;                 // accumulator dims of a lane
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// dynamic shared bytes: q rows (fp32), the split's block ids, the ring
template <typename T, int DP>
__host__ __device__ inline size_t smem_bytes(int rows, int bps) {
  return sizeof(float) * rows * DP + sizeof(int) * round4(bps) +
         (size_t)kStages * Shape<T, DP>::kStage;
}

// N consecutive elements of shared memory, widened to fp32
template <int N>
__device__ __forceinline__ void widen(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  } else {
    static_assert(N == 2, "2, or a multiple of 4, elements");
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(h[j]);
        f[i + 2 * j] = t.x; f[i + 2 * j + 1] = t.y;
      }
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    static_assert(N == 2, "2, 4, or a multiple of 8, elements");
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = t.x; f[1] = t.y;
  }
}

// part: the partials, m and l per (query row, split), then from the next
// multiple of 4 floats acc[d] per (query row, split); counters: per (token,
// KV head), 0 between launches. Both unused when every token's context lies
// in one split.
template <typename T, int DP, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ slots,
                    const int* __restrict__ positions, const int* __restrict__ block_tables,
                    int bt_stride, T* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ counters, int hq, int hkv, int d, int bs, int bps,
                    int splits, float scale) {
  namespace hw = dstpu::hopper;
  using S = Shape<T, DP>;
  constexpr int KEYS = S::kKeys;
  constexpr int E = S::kPerLane;
  constexpr int ROWS = kWarps * RPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_last;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][DP]
  int* ids = reinterpret_cast<int*>(qs + ROWS * DP);
  unsigned char* ring_p = reinterpret_cast<unsigned char*>(ids + round4(bps));
  const uint32_t ring = hw::smem_addr(ring_p);

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int pos = positions[t];
  const int n_blk = pos / bs + 1;  // blocks the token sees
  const int b0 = s * bps;
  if (b0 >= n_blk) return;  // the split starts past the token's last block
  const int b1 = min(b0 + bps, n_blk);
  const int n_live = (n_blk + bps - 1) / bps;  // splits holding some of its blocks
  const int k0 = b0 * bs;                     // the split's first key
  const int split_end = b1 * bs;
  const int last_key = min(split_end, pos + 1);  // keys k0 .. last_key - 1 are read
  const int n_steps = (last_key - k0 + KEYS - 1) / KEYS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = hq / hkv;
  const long long row0 = (long long)t * hq + (long long)h * rep;  // the group's first q row

  const int* table = block_tables + (long long)slots[t] * bt_stride;
  for (int i = tid; i < b1 - b0; i += kThreads) ids[i] = table[b0 + i];
  // the group's q rows, scaled; rows past rep and dims past d are zeros
  for (int i = tid; i < ROWS * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    qs[i] = r < rep && c < d ? dstpu::to_float(q[(row0 + r) * d + c]) * scale : 0.f;
  }
  __syncthreads();

  // keys k0 + j KEYS .. + KEYS - 1 into ring stage j % kStages; zeros past
  // last_key and past d. The thread copies chunk cc of rows rr, rr + R, ...;
  // it divides by bs once a step and walks the blocks from there.
  constexpr int R = kThreads / S::kChunks;  // rows the CTA copies in one pass
  static_assert(KEYS % R == 0, "a step is a whole number of passes");
  const int cc = tid % S::kChunks;
  const int rr = tid / S::kChunks;
  const bool col_ok = cc * S::kVec < d;
  const long long key_stride = (long long)hkv * d;
  const long long col = (long long)h * d + cc * S::kVec;
  auto load_step = [&](int j) {
    const uint32_t kdst = ring + (j % kStages) * S::kStage + rr * S::kLd + cc * 16;
    const uint32_t vdst = kdst + KEYS * S::kLd;
    int kpos = k0 + j * KEYS + rr;
    int blk = kpos / bs;
    int off = kpos - blk * bs;
#pragma unroll
    for (int n = 0; n < KEYS / R; ++n) {
      const bool ok = col_ok && kpos < last_key;
      const long long src = ok ? ((long long)ids[blk - b0] * bs + off) * key_stride + col : 0;
      hw::cp_async16(kdst + n * R * S::kLd, k_pool + src, ok);
      hw::cp_async16(vdst + n * R * S::kLd, v_pool + src, ok);
      kpos += R;
      off += R;
      while (off >= bs) {
        off -= bs;
        ++blk;
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps) load_step(j);
    hw::cp_async_commit();
  }

  const int r0 = warp * RPW;  // the warp's first row of the group
  const int dim0 = lane * E;  // the lane's first accumulator dim
  float m[RPW], l[RPW], acc[RPW][E];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = dstpu::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_steps; ++j) {
    hw::cp_async_wait<kStages - 2>();  // this thread's copies of step j landed
    __syncthreads();                   // everyone's; and step j - 1 is consumed
    if (j + kStages - 1 < n_steps) load_step(j + kStages - 1);
    hw::cp_async_commit();
    if (r0 >= rep) continue;  // a warp with no query head of the group

    const unsigned char* kb = ring_p + (j % kStages) * S::kStage;
    const unsigned char* vb = kb + KEYS * S::kLd;

    // scores: lane kk dots key k0 + j KEYS + kk with the warp's rows, in 4
    // independent partial sums a row (a shorter chain of dependent FMAs)
    float sc[RPW], dot[RPW][4];
#pragma unroll
    for (int i = 0; i < RPW; ++i) dot[i][0] = dot[i][1] = dot[i][2] = dot[i][3] = 0.f;
    if (lane < KEYS) {
      const T* kr = reinterpret_cast<const T*>(kb + lane * S::kLd);
#pragma unroll 8
      for (int cc = 0; cc < S::kChunks; ++cc) {
        float kf[S::kVec];
        widen<S::kVec>(kr + cc * S::kVec, kf);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float qf[S::kVec];
          widen<S::kVec>(qs + (r0 + i) * DP + cc * S::kVec, qf);
#pragma unroll
          for (int e = 0; e < S::kVec; ++e) dot[i][e & 3] = fmaf(qf[e], kf[e], dot[i][e & 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = (dot[i][0] + dot[i][1]) + (dot[i][2] + dot[i][3]);
    const int kpos = k0 + j * KEYS + lane;
    const bool seen = lane < KEYS && kpos <= pos && kpos < split_end;

    // online softmax update of each row
    float pr[RPW], corr[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float x = seen ? sc[i] : dstpu::kNegInf;
      const float m_new = fmaxf(m[i], dstpu::warp_max(x));
      pr[i] = seen ? expf(x - m_new) : 0.f;
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + dstpu::warp_sum(pr[i]);
      m[i] = m_new;
    }

    // acc = acc * corr + p V
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr[i];
#pragma unroll 4
    for (int kk = 0; kk < KEYS; ++kk) {
      float vf[E];
      widen<E>(reinterpret_cast<const T*>(vb + kk * S::kLd) + dim0, vf);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pk = __shfl_sync(0xffffffffu, pr[i], kk);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pk, vf[e], acc[i][e]);
      }
    }
  }
  hw::cp_async_wait<0>();  // no copy outlives the CTA

  if (n_live == 1) {  // the token's whole context lies in this split
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (r0 + i >= rep) continue;
      const float safe_l = fmaxf(l[i], 1e-30f);
      T* dst = out + (row0 + r0 + i) * d;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (dim0 + e < d) dst[dim0 + e] = dstpu::from_float<T>(acc[i][e] / safe_l);
    }
    return;
  }

  // partials of the split, then the count; the last live split merges
  float* ml = part;  // [rows][splits][2]
  float* accp = part + round4((int)gridDim.x * hq * splits * 2);  // [rows][splits][d]
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (r0 + i >= rep) continue;
    const long long slot = (row0 + r0 + i) * splits + s;
    if (lane == 0) {
      ml[2 * slot] = m[i];
      ml[2 * slot + 1] = l[i];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (dim0 + e < d) accp[slot * d + dim0 + e] = acc[i][e];
  }
  __threadfence();  // the partials are visible before the count
  __syncthreads();
  int* counter = counters + (long long)t * hkv + h;
  if (tid == 0) s_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // a thread takes 4 dims of a row: the row's largest m over the live
  // splits, then in split order the weights exp(m_s - m), the sum of l_s
  // and of acc_s, each weighted; every thread of a row computes the same m
  // and denominator, bit for bit. The loads of a pass are independent, so
  // the unrolled loops keep several in flight.
  for (int i = tid; i < rep * (d / 4); i += kThreads) {
    const int r = i / (d / 4);
    const int c = (i - r * (d / 4)) * 4;
    const float* mlr = ml + 2 * (row0 + r) * splits;
    float mx = dstpu::kNegInf;
#pragma unroll 8
    for (int u = 0; u < n_live; ++u) mx = fmaxf(mx, __ldcg(mlr + 2 * u));
    const float* ar = accp + (row0 + r) * splits * d + c;
    float lsum = 0.f;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int u = 0; u < n_live; ++u) {
      const float w = expf(__ldcg(mlr + 2 * u) - mx);
      lsum += __ldcg(mlr + 2 * u + 1) * w;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(ar + u * d));
      a[0] += v.x * w;
      a[1] += v.y * w;
      a[2] += v.z * w;
      a[3] += v.w * w;
    }
    const float denom = fmaxf(lsum, 1e-30f);
    T* dst = out + (row0 + r) * d + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = dstpu::from_float<T>(a[e] / denom);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k_pool, *v_pool, *slots, *positions, *block_tables;
  void *out, *part, *counters;
  int bt_stride, n_tokens, hq, hkv, d, bs, bps, splits;
  float scale;
};

template <typename T, int DP, int RPW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DP>(kWarps * RPW, a.bps);
  cudaError_t err = dstpu::allow_smem(paged_decode_kernel<T, DP, RPW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_tokens, a.hkv, a.splits);
  paged_decode_kernel<T, DP, RPW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const int*>(a.slots),
      static_cast<const int*>(a.positions), static_cast<const int*>(a.block_tables),
      a.bt_stride, static_cast<T*>(a.out), static_cast<float*>(a.part),
      static_cast<int*>(a.counters), a.hq, a.hkv, a.d, a.bs, a.bps, a.splits, a.scale);
  return cudaGetLastError();
}

// the head dim padded to 64, 128 or 256 (loads zero-fill past d, so a
// smaller head dim reads no more bytes at 64)
inline int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// rows per warp: the query heads of one KV head spread over the 4 warps
inline int rows_per_warp(int rep) {
  int rpw = 1;
  while (rpw * kWarps < rep) rpw *= 2;
  return rpw;
}

template <typename T, int DP>
cudaError_t dispatch_rows(const Args& a, cudaStream_t stream) {
  switch (rows_per_warp(a.hq / a.hkv)) {
    case 1: return launch<T, DP, 1>(a, stream);
    case 2: return launch<T, DP, 2>(a, stream);
    case 4: return launch<T, DP, 4>(a, stream);
    case 8: return launch<T, DP, 8>(a, stream);
    default: return cudaErrorInvalidValue;  // more than 32 query heads per KV head
  }
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.d < 8 || a.d > 256 || (a.d * (int)sizeof(T)) % 16 || a.bps < 1 || a.splits < 1)
    return cudaErrorInvalidValue;
  switch (padded_dim(a.d)) {
    case 64: return dispatch_rows<T, 64>(a, stream);
    case 128: return dispatch_rows<T, 128>(a, stream);
    default: return dispatch_rows<T, 256>(a, stream);
  }
}

template <typename T>
size_t smem_of(int rep, int d, int bps) {
  const int rows = kWarps * rows_per_warp(rep);
  switch (padded_dim(d)) {
    case 64: return smem_bytes<T, 64>(rows, bps);
    case 128: return smem_bytes<T, 128>(rows, bps);
    default: return smem_bytes<T, 256>(rows, bps);
  }
}

}  // namespace

// bps: blocks of the table a split owns; splits: ceil(table width / bps).
// part, counters: the workspace (fp32: m and l per (query row, split), then
// from the next multiple of 4 floats acc[d] per (query row, split); int32
// [n_tokens * hkv], zero between launches); unused when splits == 1.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dstpu_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* slots, const void* positions,
                                  const void* block_tables, int bt_stride, void* out, void* part,
                                  void* counters, int n_tokens, int hq, int hkv, int d, int bs,
                                  int bps, int splits, float scale, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k_pool, v_pool, slots, positions, block_tables, out, part, counters,
               bt_stride, n_tokens, hq, hkv, d, bs, bps, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(a, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" size_t dstpu_paged_decode_smem_bytes(int hq, int hkv, int d, int dtype, int bps) {
  return dtype == 1 ? smem_of<__nv_bfloat16>(hq / hkv, d, bps)
                    : smem_of<float>(hq / hkv, d, bps);
}
