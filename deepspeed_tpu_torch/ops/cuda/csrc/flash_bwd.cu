// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the dQ
// kernel.
//
// Replace the TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py:170
// `_dkdv_kernel` and :216 `_dq_kernel` (reached through `_flash_bwd_pallas`).
// Both recompute p = exp(s * scale - lse) from the forward's saved lse and
// take delta = rowsum(dO * O) in fp32 (a torch reduction before the launch,
// as the reference leaves it to XLA); ds = p * (dp - delta) * scale with
// dp = dO v^T. Masked scores are -1e30, so exp(s - lse) is exactly 0 there;
// the causal mask is the forward's (q_pos >= k_pos, from 0 on both sides).
//
// What bounds them on the H100: at the training shapes dK/dV does 4 and dQ 3
// tile products per visible (query, key) pair, each 2 flops per head dim,
// against about 2 bytes per element of their inputs and outputs: far above
// the card's ridge, so the bound is the tensor cores' rate.
//
// Design. Two kernels, as in the reference, so neither needs atomics and the
// gradients are the same from run to run.
// - dK/dV: one CTA per (batch, KV head, 64-key tile). It keeps the k and v
//   tiles in shared memory and dK, dV for its 64 keys in fp32 registers,
//   loops over the Hq/Hkv q-heads of its group and, for each, over the q
//   tiles that can see its keys, and writes dK and dV once, in k's dtype.
//   The GQA sum over the group, which the reference does after its kernel
//   over two [B, Hq, S, D] fp32 buffers (134 MB each at Llama-3-8B training
//   shapes), happens in registers.
// - dQ: one CTA per (batch, q-head, 64-row q tile), looping over the kv
//   tiles its rows can see, with dQ in registers.
// CTAs with more tiles to visit are launched first. Each kernel comes in
// two forms, chosen by dtype: bf16 (the training path) on the tensor cores
// with `mma.sync` (flash_mma.cuh: 4 warps of 16 rows; s and dp stay in
// registers and, packed to bf16, are the A operands of the dV, dK and dQ
// products; q, dO and k are also staged transposed), and fp32 with
// CUDA-core FMAs (flash_common.cuh: 256 threads of 4 rows x D/16 columns).

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using dstpu::flash::kBlock;
using dstpu::flash::kLP;
using dstpu::flash::kThreads;
using dstpu::flash::Strides;

__device__ __forceinline__ bool hidden(int qpos, int kpos, int n_q, int n_kv, int causal) {
  return qpos >= n_q || kpos >= n_kv || (causal && kpos > qpos);
}

// the dQ kernels' score gradient
__device__ __forceinline__ float dq_score(float p, float dp, float delta, float scale) {
  return p * (dp - delta) * scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                  int hq, int hkv, int n_q, int n_kv, int causal, float scale) {
  namespace fl = dstpu::flash;
  constexpr int LD = D + fl::kPad;
  constexpr int G = D / 64;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + kBlock * LD;
  float* pts = dos + kBlock * LD;  // p^T  [key][q]
  float* dts = pts + kBlock * kLP;  // ds^T [key][q]
  float* lse_s = dts + kBlock * kLP;
  float* delta_s = lse_s + kBlock;

  const int kb = blockIdx.x;  // the first key tiles see the most q tiles
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kb * kBlock;

  fl::load_tile<T, D>(ks, k, sk, b, kvh, k0, n_kv, 1.f);
  fl::load_tile<T, D>(vs, v, sv, b, kvh, k0, n_kv, 1.f);

  float dk_acc[4][4 * G], dv_acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qb = (n_q + kBlock - 1) / kBlock;
  const int first_qb = causal ? k0 / kBlock : 0;  // q tiles ending before k0 see none of these keys
  for (int h = kvh * rep; h < (kvh + 1) * rep; ++h) {
    const long long row_base = ((long long)b * hq + h) * n_q;
    for (int i = first_qb; i < n_qb; ++i) {
      const int q0 = i * kBlock;
      __syncthreads();  // every warp is done with the previous q / dO tiles
      fl::load_tile<T, D>(qs, q, sq, b, h, q0, n_q, 1.f);
      fl::load_tile<T, D>(dos, dout, sdo, b, h, q0, n_q, 1.f);
      fl::load_rows(lse_s, lse + row_base, q0, n_q);
      fl::load_rows(delta_s, delta + row_base, q0, n_q);
      __syncthreads();

      // s^T and dp^T: rows are this CTA's keys ty + 16 a, columns q rows tx + 16 c
      float s[4][4], dp[4][4];
      fl::tile_nt<D>(s, ks, LD, qs, LD, ty, tx);
      fl::tile_nt<D>(dp, vs, LD, dos, LD, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int key = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qr = tx + 16 * c;
          const float sc =
              hidden(q0 + qr, k0 + key, n_q, n_kv, causal) ? dstpu::kNegInf : s[a][c] * scale;
          const float p = expf(sc - lse_s[qr]);
          pts[key * kLP + qr] = p;
          dts[key * kLP + qr] = p * (dp[a][c] - delta_s[qr]) * scale;
        }
      }
      __syncwarp();  // a row of p^T / ds^T is read back only by the half-warp that wrote it
      fl::tile_nn<kBlock, G>(dv_acc, pts, kLP, dos, LD, ty, tx);
      fl::tile_nn<kBlock, G>(dk_acc, dts, kLP, qs, LD, ty, tx);
    }
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  fl::store_rows<T, G>(dk, sdk, b, kvh, k0, n_kv, dk_acc, one, ty, tx);
  fl::store_rows<T, G>(dv, sdv, b, kvh, k0, n_kv, dv_acc, one, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk,
                Strides sv, Strides sdo, Strides sdq, int hq, int hkv, int n_q, int n_kv,
                int causal, float scale) {
  namespace fl = dstpu::flash;
  constexpr int LD = D + fl::kPad;
  constexpr int G = D / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* dss = vs + kBlock * LD;  // ds [q][key]
  float* lse_s = dss + kBlock * kLP;
  float* delta_s = lse_s + kBlock;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qb * kBlock;
  const long long row_base = ((long long)b * hq + h) * n_q;

  fl::load_tile<T, D>(qs, q, sq, b, h, q0, n_q, 1.f);
  fl::load_tile<T, D>(dos, dout, sdo, b, h, q0, n_q, 1.f);
  fl::load_rows(lse_s, lse + row_base, q0, n_q);
  fl::load_rows(delta_s, delta + row_base, q0, n_q);

  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;

  int n_blocks = (n_kv + kBlock - 1) / kBlock;
  if (causal) n_blocks = min(n_blocks, (q0 + kBlock - 1) / kBlock + 1);
  for (int j = 0; j < n_blocks; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous k / v tiles
    fl::load_tile<T, D>(ks, k, sk, b, kvh, k0, n_kv, 1.f);
    fl::load_tile<T, D>(vs, v, sv, b, kvh, k0, n_kv, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    fl::tile_nt<D>(s, qs, LD, ks, LD, ty, tx);
    fl::tile_nt<D>(dp, dos, LD, vs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        const float sc =
            hidden(q0 + qr, k0 + key, n_q, n_kv, causal) ? dstpu::kNegInf : s[i][c] * scale;
        const float p = expf(sc - lse_s[qr]);
        dss[qr * kLP + key] = dq_score(p, dp[i][c], delta_s[qr], scale);
      }
    }
    __syncwarp();  // a row of ds is read back only by the half-warp that wrote it
    fl::tile_nn<kBlock, G>(acc, dss, kLP, ks, LD, ty, tx);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  fl::store_rows<T, G>(dq, sdq, b, h, q0, n_q, acc, one, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(dstpu::flash::mma::kThreads)
flash_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides sq,
                      Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int hq,
                      int hkv, int n_q, int n_kv, int causal, float scale) {
  namespace mm = dstpu::flash::mma;
  constexpr int LD = D + mm::kPadH;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlock * LD;
  __nv_bfloat16* qs = vs + kBlock * LD;
  __nv_bfloat16* dos = qs + kBlock * LD;
  __nv_bfloat16* qt = dos + kBlock * LD;  // q transposed: [D][64]
  __nv_bfloat16* dot = qt + D * mm::kLT;  // dO transposed
  float* lse_s = reinterpret_cast<float*>(dot + D * mm::kLT);
  float* delta_s = lse_s + kBlock;

  const int kb = blockIdx.x;  // the first key tiles see the most q tiles
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's keys in the tile
  const int k0 = kb * kBlock;

  mm::stage_rows<D>(ks, k, sk, b, kvh, k0, n_kv);
  mm::stage_rows<D>(vs, v, sv, b, kvh, k0, n_kv);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qb = (n_q + kBlock - 1) / kBlock;
  const int first_qb = causal ? k0 / kBlock : 0;  // q tiles ending before k0 see none of these keys
  for (int h = kvh * rep; h < (kvh + 1) * rep; ++h) {
    const long long row_base = ((long long)b * hq + h) * n_q;
    for (int i = first_qb; i < n_qb; ++i) {
      const int q0 = i * kBlock;
      __syncthreads();  // every warp is done with the previous q / dO tiles
      mm::stage_rows<D>(qs, q, sq, b, h, q0, n_q);
      mm::stage_rows<D>(dos, dout, sdo, b, h, q0, n_q);
      mm::stage_cols<D>(qt, q, sq, b, h, q0, n_q);
      mm::stage_cols<D>(dot, dout, sdo, b, h, q0, n_q);
      for (int r = threadIdx.x; r < kBlock; r += mm::kThreads) {
        lse_s[r] = q0 + r < n_q ? lse[row_base + q0 + r] : 0.f;
        delta_s[r] = q0 + r < n_q ? delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T: rows are the warp's keys, columns the tile's q rows
      float s[8][4], dp[8][4];
      mm::warp_nt<D>(s, ks, LD, r0, qs, LD, g, c);
      mm::warp_nt<D>(dp, vs, LD, r0, dos, LD, g, c);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + r0 + g + (e >> 1) * 8;
          const int qr = 8 * n + 2 * c + (e & 1);
          const float sc =
              hidden(q0 + qr, key, n_q, n_kv, causal) ? dstpu::kNegInf : s[n][e] * scale;
          s[n][e] = expf(sc - lse_s[qr]);
          dp[n][e] = s[n][e] * (dp[n][e] - delta_s[qr]) * scale;
        }
      uint32_t pa[4][4];
      mm::to_a(pa, s);
      mm::warp_pv<NT>(dv_acc, pa, dot, g, c);  // dV += p^T dO
      mm::to_a(pa, dp);
      mm::warp_pv<NT>(dk_acc, pa, qt, g, c);   // dK += ds^T q
    }
  }

  const float one[2] = {1.f, 1.f};
  mm::store_acc<NT>(dk, sdk, b, kvh, k0 + r0, n_kv, dk_acc, one, g, c);
  mm::store_acc<NT>(dv, sdv, b, kvh, k0 + r0, n_kv, dv_acc, one, g, c);
}

template <int D>
__global__ void __launch_bounds__(dstpu::flash::mma::kThreads)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, int hq, int hkv, int n_q, int n_kv, int causal,
                    float scale) {
  namespace mm = dstpu::flash::mma;
  constexpr int LD = D + mm::kPadH;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBlock * LD;
  __nv_bfloat16* ks = dos + kBlock * LD;
  __nv_bfloat16* vs = ks + kBlock * LD;
  __nv_bfloat16* kt = vs + kBlock * LD;  // k transposed: [D][64]
  float* lse_s = reinterpret_cast<float*>(kt + D * mm::kLT);
  float* delta_s = lse_s + kBlock;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int q0 = qb * kBlock;
  const long long row_base = ((long long)b * hq + h) * n_q;

  mm::stage_rows<D>(qs, q, sq, b, h, q0, n_q);
  mm::stage_rows<D>(dos, dout, sdo, b, h, q0, n_q);
  for (int r = threadIdx.x; r < kBlock; r += mm::kThreads) {
    lse_s[r] = q0 + r < n_q ? lse[row_base + q0 + r] : 0.f;
    delta_s[r] = q0 + r < n_q ? delta[row_base + q0 + r] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_blocks = (n_kv + kBlock - 1) / kBlock;
  if (causal) n_blocks = min(n_blocks, (q0 + kBlock - 1) / kBlock + 1);
  for (int j = 0; j < n_blocks; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous k / v tiles
    mm::stage_rows<D>(ks, k, sk, b, kvh, k0, n_kv);
    mm::stage_rows<D>(vs, v, sv, b, kvh, k0, n_kv);
    mm::stage_cols<D>(kt, k, sk, b, kvh, k0, n_kv);
    __syncthreads();

    float s[8][4], dp[8][4];
    mm::warp_nt<D>(s, qs, LD, r0, ks, LD, g, c);
    mm::warp_nt<D>(dp, dos, LD, r0, vs, LD, g, c);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = r0 + g + (e >> 1) * 8;
        const int key = k0 + 8 * n + 2 * c + (e & 1);
        const float sc =
            hidden(q0 + qr, key, n_q, n_kv, causal) ? dstpu::kNegInf : s[n][e] * scale;
        const float p = expf(sc - lse_s[qr]);
        s[n][e] = dq_score(p, dp[n][e], delta_s[qr], scale);
      }
    uint32_t pa[4][4];
    mm::to_a(pa, s);
    mm::warp_pv<NT>(acc, pa, kt, g, c);  // dQ += ds k
  }

  const float one[2] = {1.f, 1.f};
  mm::store_acc<NT>(dq, sdq, b, h, q0 + r0, n_q, acc, one, g, c);
}

constexpr size_t dkdv_smem_bytes(int d) { return dstpu::flash::smem_bytes(d, 4, 2, 2); }
constexpr size_t dq_smem_bytes(int d) { return dstpu::flash::smem_bytes(d, 4, 1, 2); }
constexpr size_t dkdv_mma_smem_bytes(int d) { return dstpu::flash::mma::smem_bytes(d, 4, 2, 2); }
constexpr size_t dq_mma_smem_bytes(int d) { return dstpu::flash::mma::smem_bytes(d, 4, 1, 2); }

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  Strides st[6];  // q, k, v, dO, then dK, dV (dkdv) or dQ (dq)
  int b, n_q, n_kv, hq, hkv, causal;
  float scale;
};

template <typename T, int D>
cudaError_t launch_dkdv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_dkdv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kBlock - 1) / kBlock, a.hkv, a.b);
  flash_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.hq, a.hkv, a.n_q, a.n_kv,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kBlock - 1) / kBlock, a.hq, a.b);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.st[0], a.st[1], a.st[2],
      a.st[3], a.st[4], a.hq, a.hkv, a.n_q, a.n_kv, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_mma(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = dkdv_mma_smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_dkdv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kBlock - 1) / kBlock, a.hkv, a.b);
  flash_dkdv_mma_kernel<D><<<grid, dstpu::flash::mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.hq, a.hkv, a.n_q, a.n_kv,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = dq_mma_smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kBlock - 1) / kBlock, a.hq, a.b);
  flash_dq_mma_kernel<D><<<grid, dstpu::flash::mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.st[0], a.st[1], a.st[2],
      a.st[3], a.st[4], a.hq, a.hkv, a.n_q, a.n_kv, a.causal, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch(bool dkdv, const Args& a, int d, int dtype, cudaStream_t s) {
  if (dtype == 0 && d == 64) return dkdv ? launch_dkdv<float, 64>(a, s) : launch_dq<float, 64>(a, s);
  if (dtype == 0 && d == 128) return dkdv ? launch_dkdv<float, 128>(a, s) : launch_dq<float, 128>(a, s);
  if (dtype == 1 && d == 64) return dkdv ? launch_dkdv_mma<64>(a, s) : launch_dq_mma<64>(a, s);
  if (dtype == 1 && d == 128) return dkdv ? launch_dkdv_mma<128>(a, s) : launch_dq_mma<128>(a, s);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const long long* strides, int n_strided, int b, int n_q,
               int n_kv, int hq, int hkv, int causal, float scale) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  for (int t = 0; t < n_strided; ++t)
    a.st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  a.b = b; a.n_q = n_q; a.n_kv = n_kv; a.hq = hq; a.hkv = hkv; a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// strides: element strides (batch, seq, head) of q, k, v, dO, dK, dV in turn
// (18 values). lse, delta: contiguous fp32 [B, Hq, Sq]. dtype: 0 = float32,
// 1 = bfloat16; d: 64 or 128. Returns a cudaError_t (0 = launched).
extern "C" int dstpu_flash_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const long long* strides, int b, int n_q, int n_kv, int hq,
                                int hkv, int d, int causal, float scale, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, dout, lse, delta, strides, 6, b, n_q, n_kv, hq, hkv, causal, scale);
  a.dk = dk;
  a.dv = dv;
  return (int)dispatch(true, a, d, dtype, static_cast<cudaStream_t>(stream));
}

// strides: element strides of q, k, v, dO, dQ in turn (15 values).
extern "C" int dstpu_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              const long long* strides, int b, int n_q, int n_kv, int hq,
                              int hkv, int d, int causal, float scale, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, dout, lse, delta, strides, 5, b, n_q, n_kv, hq, hkv, causal, scale);
  a.dq = dq;
  return (int)dispatch(false, a, d, dtype, static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core kernels)
extern "C" size_t dstpu_flash_dkdv_smem_bytes(int d, int dtype) {
  return dtype == 1 ? dkdv_mma_smem_bytes(d) : dkdv_smem_bytes(d);
}
extern "C" size_t dstpu_flash_dq_smem_bytes(int d, int dtype) {
  return dtype == 1 ? dq_mma_smem_bytes(d) : dq_smem_bytes(d);
}
