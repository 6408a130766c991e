// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py:40
// `_fwd_kernel` (reached through `_flash_fwd` and `flash_attention`):
// causal or full attention with an online softmax, returning o in q's dtype
// and lse = m + log(l) in fp32 [B, Hq, Sq]. Same arithmetic as the Pallas
// kernel: masked scores are -1e30, the causal mask is q_pos >= k_pos
// counted from 0 on both sides (aligned at the top left, also when
// Sq != Skv), and l is floored at 1e-30.
//
// What bounds it on the H100: at the training shapes (S = 4096, D = 128) it
// does 4 flops per visible (query, key) pair and head dim against 2 bytes per
// element of q, k, v, o read or written once: about 1600 flops a byte, far
// above the card's ridge, so the bound is the tensor cores' rate.
//
// Design: the TPU kernel walks a sequential (q block, kv block) grid,
// carrying m, l and the accumulator in VMEM scratch from one grid step to
// the next. Hopper CTAs run in no order, so one CTA owns a 64-row q tile for
// one (batch, head) and loops itself over the kv tiles it can see (all of
// them, or under the causal mask only those up to the tile's last row):
// blocks strictly above the diagonal are never loaded. GQA maps head h to
// kv head h / (Hq / Hkv) without replicating k or v. CTAs with more visible
// kv tiles are launched first. Two kernels, chosen by dtype:
// - bf16 (the training path): `mma.sync` on the tensor cores
//   (flash_mma.cuh). Each of 4 warps owns 16 rows; S = q k^T stays in
//   registers, and p, packed to bf16, is the A operand of p v (v staged
//   transposed). Scores are scaled in fp32 after the product.
// - fp32: CUDA-core FMAs in fp32 throughout (flash_common.cuh), 256
//   threads each holding 4 rows x D/16 columns; q is scaled before the
//   dot, as the Pallas kernel does.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using dstpu::flash::kBlock;
using dstpu::flash::kLP;
using dstpu::flash::kThreads;
using dstpu::flash::Strides;

// a key the query at qpos does not see
__device__ __forceinline__ bool fwd_hidden(int qpos, int kpos, int n_kv, int causal) {
  return kpos >= n_kv || (causal && kpos > qpos);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int hq, int hkv, int n_q, int n_kv, int causal, float scale) {
  namespace fl = dstpu::flash;
  constexpr int LD = D + fl::kPad;
  constexpr int G = D / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* ps = vs + kBlock * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qb * kBlock;

  fl::load_tile<T, D>(qs, q, sq, b, h, q0, n_q, scale);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = dstpu::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  int n_blocks = (n_kv + kBlock - 1) / kBlock;
  if (causal) n_blocks = min(n_blocks, (q0 + kBlock - 1) / kBlock + 1);
  for (int j = 0; j < n_blocks; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous k / v tiles
    fl::load_tile<T, D>(ks, k, sk, b, kvh, k0, n_kv, 1.f);
    fl::load_tile<T, D>(vs, v, sv, b, kvh, k0, n_kv, 1.f);
    __syncthreads();

    float s[4][4];
    fl::tile_nt<D>(s, qs, LD, ks, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = dstpu::kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (fwd_hidden(qpos, kpos, n_kv, causal)) s[i][c] = dstpu::kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], fl::half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        ps[(ty + 16 * i) * kLP + tx + 16 * c] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + fl::half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row of p is read back only by the half-warp that wrote it
    fl::tile_nn<kBlock, G>(acc, ps, kLP, vs, LD, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe_l = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / safe_l;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < n_q) lse[((long long)b * hq + h) * n_q + r] = m[i] + logf(safe_l);
  }
  fl::store_rows<T, G>(o, so, b, h, q0, n_q, acc, inv, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(dstpu::flash::mma::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                     int hq, int hkv, int n_q, int n_kv, int causal, float scale) {
  namespace mm = dstpu::flash::mma;
  constexpr int LD = D + mm::kPadH;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlock * LD;
  __nv_bfloat16* vt = ks + kBlock * LD;  // v transposed: [D][64]

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int q0 = qb * kBlock;

  mm::stage_rows<D>(qs, q, sq, b, h, q0, n_q);

  float m[2] = {dstpu::kNegInf, dstpu::kNegInf}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_blocks = (n_kv + kBlock - 1) / kBlock;
  if (causal) n_blocks = min(n_blocks, (q0 + kBlock - 1) / kBlock + 1);
  for (int j = 0; j < n_blocks; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous k / v tiles
    mm::stage_rows<D>(ks, k, sk, b, kvh, k0, n_kv);
    mm::stage_cols<D>(vt, v, sv, b, kvh, k0, n_kv);
    __syncthreads();

    float s[8][4];
    mm::warp_nt<D>(s, qs, LD, r0, ks, LD, g, c);
    float mx[2] = {dstpu::kNegInf, dstpu::kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + r0 + g + (e >> 1) * 8;
        const int kpos = k0 + 8 * n + 2 * c + (e & 1);
        s[n][e] = fwd_hidden(qpos, kpos, n_kv, causal) ? dstpu::kNegInf : s[n][e] * scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], mm::quad_max(mx[half]));
      corr[half] = expf(m[half] - m_new);
      m[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + mm::quad_sum(rs[half]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    uint32_t pa[4][4];
    mm::to_a(pa, s);
    mm::warp_pv<NT>(acc, pa, vt, g, c);
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float safe_l = fmaxf(l[half], 1e-30f);
    inv[half] = 1.f / safe_l;
    const int r = q0 + r0 + g + 8 * half;
    if (c == 0 && r < n_q) lse[((long long)b * hq + h) * n_q + r] = m[half] + logf(safe_l);
  }
  mm::store_acc<NT>(o, so, b, h, q0 + r0, n_q, acc, inv, g, c);
}

constexpr size_t smem_bytes(int d) { return dstpu::flash::smem_bytes(d, 3, 1, 0); }
constexpr size_t mma_smem_bytes(int d) { return dstpu::flash::mma::smem_bytes(d, 2, 1, 0); }

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Strides* st, int b, int n_q, int n_kv, int hq, int hkv, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBlock - 1) / kBlock, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st[0], st[1], st[2], st[3], hq, hkv, n_q, n_kv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Strides* st, int b, int n_q, int n_kv, int hq, int hkv, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBlock - 1) / kBlock, hq, b);
  flash_fwd_mma_kernel<D><<<grid, dstpu::flash::mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, st[0], st[1],
      st[2], st[3], hq, hkv, n_q, n_kv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v, o in turn.
// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128. Returns a cudaError_t
// (0 = launched).
extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               const long long* strides, int b, int n_q, int n_kv, int hq,
                               int hkv, int d, int causal, float scale, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && d == 64)
    err = launch<float, 64>(q, k, v, o, l, st, b, n_q, n_kv, hq, hkv, causal, scale, s);
  else if (dtype == 0 && d == 128)
    err = launch<float, 128>(q, k, v, o, l, st, b, n_q, n_kv, hq, hkv, causal, scale, s);
  else if (dtype == 1 && d == 64)
    err = launch_mma<64>(q, k, v, o, l, st, b, n_q, n_kv, hq, hkv, causal, scale, s);
  else if (dtype == 1 && d == 128)
    err = launch_mma<128>(q, k, v, o, l, st, b, n_q, n_kv, hq, hkv, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel)
extern "C" size_t dstpu_flash_fwd_smem_bytes(int d, int dtype) {
  return dtype == 1 ? mma_smem_bytes(d) : smem_bytes(d);
}
