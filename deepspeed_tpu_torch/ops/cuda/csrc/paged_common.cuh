// Shared core of the paged decode kernel (paged_decode.cu) and the fp32
// prefill kernel (paged_prefill.cu): a CTA attends a set of query rows of
// ONE sequence and ONE KV head over that sequence's blocks of the paged
// pool, streaming one KV block at a time through shared memory with an fp32
// online softmax.
//
// Pool layout [NB, BS, Hkv, D] (the JAX package's, models/paged.py): the BS
// keys of head h in block b are rows of D contiguous elements, Hkv*D apart.
//
// Each warp owns RPW rows for the whole CTA and keeps their accumulators,
// running max and running sum in registers (lane l holds dims l, l+32, ...);
// a key or value element loaded from shared memory feeds all RPW rows, which
// is what keeps the CUDA-core dots from being bound by shared-memory loads.
// Shared memory (dynamic): per row its output offset, position and scaled
// query; one K block (rows padded to D+1 floats so lane k reading key k is
// conflict-free); one V block; one probability row per warp row.

#pragma once

#include "common.cuh"

namespace dstpu {

constexpr int kMaxDim = 128;          // head dims up to 128 ...
constexpr int kDimPerLane = kMaxDim / 32;  // ... held as 4 registers a lane

struct Smem {
  long long* row_off;  // [rows] element offset of the row in q / out
  int* row_pos;        // [rows] query position; -1 marks a pad row
  float* q;            // [rows][d] scaled query
  float* k;            // [bs][d + 1]
  float* v;            // [bs][d]
  float* p;            // [rows][bs] scores, then probabilities
};

// `rows` = warps x RPW, a multiple of 4 (keeps q 16-byte aligned).
__host__ __device__ inline size_t smem_bytes(int rows, int bs, int d) {
  return sizeof(long long) * rows + sizeof(int) * rows +
         sizeof(float) * ((size_t)rows * d + (size_t)bs * (d + 1) + (size_t)bs * d +
                          (size_t)rows * bs);
}

__device__ inline Smem carve(char* base, int rows, int bs, int d) {
  Smem s;
  s.row_off = reinterpret_cast<long long*>(base);
  s.row_pos = reinterpret_cast<int*>(s.row_off + rows);
  float* f = reinterpret_cast<float*>(s.row_pos + rows);
  s.q = f; f += (size_t)rows * d;
  s.k = f; f += (size_t)bs * (d + 1);
  s.v = f; f += (size_t)bs * d;
  s.p = f;
  return s;
}

// Attend every row of s.row_off / s.row_pos (filled by the caller for all
// blockDim.x / 32 * RPW rows; row_pos < 0 marks padding, row_off < 0 a row
// that is not written) over blocks
// table_row[0 .. n_blocks-1] of KV head h. Warp w owns rows w*RPW ..
// w*RPW+RPW-1. A key at kpos is visible to a row at qpos iff kpos <= qpos;
// a pad row reads nothing and its output is zeros. Requires d <= kMaxDim and
// d % 4 == 0.
template <typename T, int RPW>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                            const int* __restrict__ table_row, int n_blocks, int bs, int hkv,
                            int d, int h, float scale, const Smem& s) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = (nthreads >> 5) * RPW;
  __syncthreads();  // row_off / row_pos visible to every thread

  for (int i = tid; i < rows * d; i += nthreads) {
    const int r = i / d;
    const int c = i - r * d;
    s.q[i] = s.row_pos[r] >= 0 ? to_float(q[s.row_off[r] + c]) * scale : 0.f;
  }

  const int r0 = warp * RPW;
  int qpos[RPW];
  float m[RPW], l[RPW], acc[RPW][kDimPerLane];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    qpos[i] = s.row_pos[r0 + i];
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kDimPerLane; ++t) acc[i][t] = 0.f;
  }
  int warp_last = -1;  // the warp's largest query position
#pragma unroll
  for (int i = 0; i < RPW; ++i) warp_last = max(warp_last, qpos[i]);

  constexpr int VEC = 16 / sizeof(T);
  const int vec_per_row = d / VEC;
  const long long key_stride = (long long)hkv * d;
  const float* qw = s.q + (size_t)r0 * d;
  float* pw = s.p + (size_t)r0 * bs;

  for (int j = 0; j < n_blocks; ++j) {
    const long long base = ((long long)table_row[j] * bs * hkv + h) * d;
    __syncthreads();  // the previous block is fully consumed (q staged on j == 0)
    for (int i = tid; i < bs * vec_per_row; i += nthreads) {
      const int kk = i / vec_per_row;
      const int c = (i - kk * vec_per_row) * VEC;
      float fk[VEC], fv[VEC];
      load16(k_pool + base + kk * key_stride + c, fk);
      load16(v_pool + base + kk * key_stride + c, fv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s.k[kk * (d + 1) + c + e] = fk[e];
        s.v[kk * d + c + e] = fv[e];
      }
    }
    __syncthreads();

    const int kpos0 = j * bs;
    if (warp_last < kpos0) continue;  // no row of this warp sees this block

    // scores: lane kk computes the dot of key kk with all RPW rows
    float mloc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) mloc[i] = kNegInf;
    for (int kk = lane; kk < bs; kk += 32) {
      const float* kr = s.k + kk * (d + 1);
      float dot[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
      for (int c = 0; c < d; c += 4) {
        const float k0 = kr[c], k1 = kr[c + 1], k2 = kr[c + 2], k3 = kr[c + 3];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * d + c);
          dot[i] = fmaf(qv.x, k0, dot[i]);
          dot[i] = fmaf(qv.y, k1, dot[i]);
          dot[i] = fmaf(qv.z, k2, dot[i]);
          dot[i] = fmaf(qv.w, k3, dot[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float sc = (kpos0 + kk <= qpos[i]) ? dot[i] : kNegInf;
        pw[i * bs + kk] = sc;
        mloc[i] = fmaxf(mloc[i], sc);
      }
    }

    // online softmax update; a row that has seen no key yet keeps p = 0
    float corr[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float m_new = fmaxf(m[i], warp_max(mloc[i]));
      float lsum = 0.f;
      for (int kk = lane; kk < bs; kk += 32) {
        const float e = m_new > 0.5f * kNegInf ? expf(pw[i * bs + kk] - m_new) : 0.f;
        pw[i * bs + kk] = e;
        lsum += e;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(lsum);
      m[i] = m_new;
    }
    __syncwarp();

    // acc = acc * corr + p @ V: lane owns dims lane + 32 t
#pragma unroll
    for (int t = 0; t < kDimPerLane; ++t)
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i][t] *= corr[i];
    for (int kk = 0; kk < bs; ++kk) {
      float pk[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) pk[i] = pw[i * bs + kk];
#pragma unroll
      for (int t = 0; t < kDimPerLane; ++t) {
        const int c = lane + 32 * t;
        if (c < d) {
          const float vv = s.v[kk * d + c];
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i][t] = fmaf(pk[i], vv, acc[i][t]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by this warp's next block
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    const long long off = s.row_off[r0 + i];
#pragma unroll
    for (int t = 0; t < kDimPerLane; ++t) {
      const int c = lane + 32 * t;
      if (off >= 0 && c < d) out[off + c] = from_float<T>(acc[i][t] / denom);
    }
  }
}

}  // namespace dstpu
