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
// - dK/dV: a CTA owns a tile of keys of one (batch, KV head). It keeps dK
//   and dV for its keys in fp32 registers, loops over the Hq/Hkv q-heads of
//   its group and, for each, over the q tiles that can see its keys, and
//   writes dK and dV once, in k's dtype. The GQA sum over the group, which
//   the reference does after its kernel over two [B, Hq, S, D] fp32 buffers
//   (134 MB each at Llama-3-8B training shapes), happens in registers.
// - dQ: one CTA per (batch, q-head, 64-row q tile), looping over the kv
//   tiles its rows can see, with dQ in registers.
// CTAs with more tiles to visit are launched first. Each kernel comes in
// two forms, chosen by dtype. fp32 runs CUDA-core FMAs (flash_common.cuh:
// 256 threads of 4 rows x D/16 columns, 64-row tiles): fp32 checks hold it
// to 1e-4, which rules out TF32. bf16 (the training path) runs on the
// tensor cores:
// - dK/dV (namespace wg): warp-specialised `wgmma` (hopper.cuh). 384
//   threads: a producer warpgroup, of which one warp keeps TMA loads of the
//   next q and dO tiles (64 rows, 128-byte swizzled) in flight in a 2-stage
//   ring, with lse and delta beside them, signalled by mbarriers; and two
//   consumer warpgroups, each owning 64 of the CTA's 128 keys (k and v
//   loaded once by TMA). Per q tile a consumer computes s^T = k q^T and
//   dp^T = v dO^T (A = k or v, B = q or dO, both K-major in shared memory),
//   then p^T and ds^T in registers, packs them to bf16 as register A
//   operands, and accumulates dV += p^T dO and dK += ds^T q with B = dO or
//   q read MN-major (the transpose bit): no operand is staged transposed.
//   setmaxnreg moves registers from the producer to the consumers.
// - dQ: `mma.sync` (flash_mma.cuh: 4 warps of 16 rows; s and dp stay in
//   registers and, packed to bf16, are the A operand of the dQ product; k
//   is also staged transposed).

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------ bf16 dK/dV: wgmma
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kKeys = 128;    // keys of a CTA: two consumer warpgroups of 64
constexpr int kQ = 64;        // q rows of a ring stage
constexpr int kStages = 2;    // ring depth
constexpr int kThreads = 384;  // producer warpgroup, then 2 consumer warpgroups
constexpr int kPanel = 64 * 128;  // bytes of a [64 rows][64 bf16] swizzled panel
constexpr float kLog2e = 1.4426950408889634f;

// Shared layout (from a 1024-byte aligned base): k, v of the CTA's keys
// ([2 halves][D/64 panels] each), then kStages stages of (q, dO [D/64
// panels] each, lse and delta [64] fp32), then the barriers.
__host__ __device__ constexpr int kv_bytes(int d) { return 2 * (d / 64) * kPanel; }
__host__ __device__ constexpr int stage_bytes(int d) { return 2 * (d / 64) * kPanel + 1024; }
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return 1024 + 2 * (size_t)kv_bytes(d) + (size_t)kStages * stage_bytes(d) + 8 * (2 * kStages + 1);
}

// descriptor offset of k-step t (16 columns) in a K-major [64 rows][D]
// operand of D / 64 swizzled panels: 32 bytes a step, kPanel a panel
__device__ __forceinline__ uint64_t kstep(int t) { return ((t / 4) * kPanel + (t % 4) * 32) >> 4; }

// d (64 x D) += A B for one 16-deep k-step, A in registers, B MN-major
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64)
    dstpu::hopper::wgmma_rs_m64n64_tb(d, a, b);
  else
    dstpu::hopper::wgmma_rs_m64n128_tb(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, Strides sdk, Strides sdv, int batch, int hq,
                        int hkv, int n_q, int n_kv, int causal, float scale) {
  namespace hw = dstpu::hopper;
  namespace mm = dstpu::flash::mma;
  constexpr int NP = D / 64;            // 64-column panels of a row
  constexpr int QT = NP * kPanel;       // bytes of a q (or dO) tile
  constexpr int KV = kv_bytes(D);
  constexpr int STAGE = stage_bytes(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hw::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t ks = base;
  const uint32_t vs = base + KV;
  const uint32_t st0 = base + 2 * KV;
  const uint32_t bars = st0 + kStages * STAGE;  // full[kStages], empty[kStages], kv
  const uint32_t kv_bar = bars + 16 * kStages;

  // longest key tiles first: with causal masking key tile kb (128 keys) sees
  // n_qb - 2 kb q tiles of each q-head
  const int per_kb = hkv * batch;
  const int kb = blockIdx.x / per_kb;
  const int kvh = (blockIdx.x - kb * per_kb) % hkv;
  const int b = (blockIdx.x - kb * per_kb) / hkv;
  const int k0 = kb * kKeys;
  const int rep = hq / hkv;
  const int n_qb = (n_q + kQ - 1) / kQ;
  // q tiles ending before k0 see none of these keys
  const int first_qb = causal ? min(k0 / kQ, n_qb) : 0;
  const int per_head = n_qb - first_qb;
  // the ring carries (q-head, q tile) pairs: every q-head of the GQA group
  const int total = rep * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(bars + 8 * s, 32);                   // the producer warp's lanes
      hw::mbar_init(bars + 8 * (kStages + s), 256);      // every consumer thread
    }
    hw::mbar_init(kv_bar, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: warp 0 keeps the ring full
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hw::mbar_arrive_tx(kv_bar, 2 * KV);
      for (int half = 0; half < 2; ++half)
        for (int p = 0; p < NP; ++p) {
          const uint32_t off = (half * NP + p) * kPanel;
          hw::tma_load_4d(ks + off, &tm_k, kv_bar, 64 * p, k0 + 64 * half, kvh, b);
          hw::tma_load_4d(vs + off, &tm_v, kv_bar, 64 * p, k0 + 64 * half, kvh, b);
        }
    }
    for (int n = 0; n < total; ++n) {
      const int s = n % kStages;
      const int h = kvh * rep + n / per_head;
      const int q0 = (first_qb + n % per_head) * kQ;
      hw::mbar_wait(bars + 8 * (kStages + s), ((n / kStages) & 1) ^ 1);  // stage free
      const uint32_t qd = st0 + s * STAGE;
      float* rows = reinterpret_cast<float*>(gbase + (qd - base) + 2 * QT);  // lse, delta
      const long long rb = ((long long)b * hq + h) * n_q;
      for (int r = lane; r < kQ; r += 32) {
        const bool in = q0 + r < n_q;
        rows[r] = in ? lse[rb + q0 + r] : 0.f;
        rows[kQ + r] = in ? delta[rb + q0 + r] : 0.f;
      }
      if (lane == 0) {
        hw::mbar_arrive_tx(bars + 8 * s, 2 * QT);
        for (int p = 0; p < NP; ++p) {
          hw::tma_load_4d(qd + p * kPanel, &tm_q, bars + 8 * s, 64 * p, q0, h, b);
          hw::tma_load_4d(qd + QT + p * kPanel, &tm_do, bars + 8 * s, 64 * p, q0, h, b);
        }
      } else {
        hw::mbar_arrive(bars + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: keys k0 + 64 cw .. + 63, dK and dV in registers
  hw::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int key_lo = k0 + 64 * cw;
  // descriptors of this warpgroup's k and v rows (K-major A operands); a
  // k-step t adds its byte offset / 16 to the start address field
  const uint64_t kdesc = hw::desc_sw128(ks + cw * NP * kPanel, 16, 1024);
  const uint64_t vdesc = hw::desc_sw128(vs + cw * NP * kPanel, 16, 1024);
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  hw::mbar_wait(kv_bar, 0);

  for (int n = 0; n < total; ++n) {
    const int s = n % kStages;
    const int q0 = (first_qb + n % per_head) * kQ;
    hw::mbar_wait(bars + 8 * s, (n / kStages) & 1);  // stage loaded
    const uint32_t qd = st0 + s * STAGE;
    const uint32_t dod = qd + QT;
    const float* rows = reinterpret_cast<const float*>(gbase + (qd - base) + 2 * QT);
    // does any row of this q tile see any of this warpgroup's keys?
    if (key_lo < n_kv && (!causal || q0 + kQ - 1 >= key_lo)) {
      // s^T = k q^T and dp^T = v dO^T: 64 keys x 64 q rows, depth D, one
      // commit group each, so p^T is computed while dp^T is in flight
      float st[32], dpt[32];  // the first k-step overwrites them
      hw::wgmma_fence();
      const uint64_t qdesc = hw::desc_sw128(qd, 16, 1024);
      const uint64_t dodesc = hw::desc_sw128(dod, 16, 1024);
#pragma unroll
      for (int t = 0; t < D / 16; ++t)
        hw::wgmma_ss_m64n64(st, kdesc + kstep(t), qdesc + kstep(t), t > 0);
      hw::wgmma_commit();
#pragma unroll
      for (int t = 0; t < D / 16; ++t)
        hw::wgmma_ss_m64n64(dpt, vdesc + kstep(t), dodesc + kstep(t), t > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();
      hw::fence_regs(st);

      // p^T = exp(s scale - lse), packed to bf16 as the A operand (64 keys x
      // 16 q rows per k-step) of dV += p^T dO, whose B = dO is read MN-major
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 16 * warp + g + 8 * (e >> 1);
          const int qr = 8 * j + 2 * c + (e & 1);
          st[4 * j + e] = hidden(q0 + qr, key, n_q, n_kv, causal)
                              ? 0.f
                              : exp2f(st[4 * j + e] * scale_log2 - rows[qr] * kLog2e);
        }
      uint32_t pa[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[t][r] = mm::pack(st[8 * t + 2 * r], st[8 * t + 2 * r + 1]);
      // MN-major B: 16 q rows (2048 bytes) a k-step, 64-column panels kPanel apart
      const uint64_t dodesc_t = hw::desc_sw128(dod, kPanel, 1024);
      hw::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) mma_rs<D>(dv_acc, pa[t], dodesc_t + t * (2048 >> 4));
      hw::wgmma_commit();

      // ds^T = p^T (dp^T - delta) scale, then dK += ds^T q (B = q, MN-major)
      hw::wgmma_wait<1>();
      hw::fence_regs(dpt);
      auto ds = [&](int i, int qr) { return st[i] * (dpt[i] - rows[kQ + qr]) * scale; };
      uint32_t da[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i0 = 8 * t + 2 * r;  // column 16 t + 8 (r / 2) + 2 c of row r % 2
          const int qr = 16 * t + 8 * (r >> 1) + 2 * c;
          da[t][r] = mm::pack(ds(i0, qr), ds(i0 + 1, qr + 1));
        }
      const uint64_t qdesc_t = hw::desc_sw128(qd, kPanel, 1024);
      hw::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) mma_rs<D>(dk_acc, da[t], qdesc_t + t * (2048 >> 4));
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(dv_acc);
      hw::fence_regs(dk_acc);
    }
    hw::mbar_arrive(bars + 8 * (kStages + s));  // stage consumed
  }

  // rows key_lo + 16 warp + g (+ 8), columns 8 j + 2 c (+ 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 16 * warp + g + 8 * half;
    if (key >= n_kv) continue;
    bf16* rk = dk + b * sdk.b + kvh * sdk.h + (long long)key * sdk.s + 2 * c;
    bf16* rv = dv + b * sdv.b + kvh * sdv.h + (long long)key * sdv.s + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(rk + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * half], dk_acc[4 * j + 2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(rv + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * half], dv_acc[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace wg

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

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, S, H, D] tensor as a 4-D tensor map: dims (D, S, H, B) and
// byte strides (S, H, B) from the wrapper (`tma_layout`), boxes of [64
// rows][64 bf16], 128-byte swizzled; rows past S read as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, const unsigned long long* layout) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {layout[0], layout[1], layout[2], layout[3]};
  const cuuint64_t strides[3] = {layout[4], layout[5], layout[6]};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_dkdv_wgmma(const Args& a, const unsigned long long* layouts,
                              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap maps[4];  // q, k, v, dO
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (int t = 0; t < 4; ++t) {
    cudaError_t err = tensor_map(&maps[t], ptrs[t], layouts + 7 * t);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = wg::smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(wg::flash_dkdv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.n_kv + wg::kKeys - 1) / wg::kKeys * a.hkv * a.b;
  wg::flash_dkdv_wgmma_kernel<D><<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.st[4], a.st[5], a.b, a.hq, a.hkv, a.n_q, a.n_kv, a.causal, a.scale);
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

// layouts: the bf16 dK/dV kernel's tensor maps (q, k, v, dO), else unused
cudaError_t dispatch(bool dkdv, const Args& a, int d, int dtype,
                     const unsigned long long* layouts, cudaStream_t s) {
  if (dtype == 0 && d == 64) return dkdv ? launch_dkdv<float, 64>(a, s) : launch_dq<float, 64>(a, s);
  if (dtype == 0 && d == 128) return dkdv ? launch_dkdv<float, 128>(a, s) : launch_dq<float, 128>(a, s);
  if (dtype == 1 && d == 64) return dkdv ? launch_dkdv_wgmma<64>(a, layouts, s) : launch_dq_mma<64>(a, s);
  if (dtype == 1 && d == 128) return dkdv ? launch_dkdv_wgmma<128>(a, layouts, s) : launch_dq_mma<128>(a, s);
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
// (18 values). layouts (bf16 only): the tensor maps of q, k, v, dO in turn,
// each dims (D, S, H, B) then byte strides (S, H, B) (28 values). lse,
// delta: contiguous fp32 [B, Hq, Sq]. dtype: 0 = float32, 1 = bfloat16; d:
// 64 or 128. Returns a cudaError_t (0 = launched).
extern "C" int dstpu_flash_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const long long* strides, const unsigned long long* layouts,
                                int b, int n_q, int n_kv, int hq, int hkv, int d, int causal,
                                float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, dout, lse, delta, strides, 6, b, n_q, n_kv, hq, hkv, causal, scale);
  a.dk = dk;
  a.dv = dv;
  return (int)dispatch(true, a, d, dtype, layouts, static_cast<cudaStream_t>(stream));
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
  return (int)dispatch(false, a, d, dtype, nullptr, static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core kernels)
extern "C" size_t dstpu_flash_dkdv_smem_bytes(int d, int dtype) {
  return dtype == 1 ? wg::smem_bytes(d) : dkdv_smem_bytes(d);
}
extern "C" size_t dstpu_flash_dq_smem_bytes(int d, int dtype) {
  return dtype == 1 ? dq_mma_smem_bytes(d) : dq_smem_bytes(d);
}
