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
// the card's ridge, so the bound is the tensor cores' rate (dK/dV 5.50e11
// flops, 0.556 ms; dQ 4.12e11 flops, 0.417 ms at the training cell's
// attention).
//
// Design. Two kernels, as in the reference, so neither needs atomics and the
// gradients are the same from run to run.
// - dK/dV: a CTA owns a tile of keys of one (batch, KV head). It keeps dK
//   and dV for its keys in fp32 registers, loops over the Hq/Hkv q-heads of
//   its group and, for each, over the q tiles that can see its keys, and
//   writes dK and dV once, in k's dtype. The GQA sum over the group, which
//   the reference does after its kernel over two [B, Hq, S, D] fp32 buffers
//   (134 MB each at Llama-3-8B training shapes), happens in registers.
// - dQ: a CTA owns a q tile of one (batch, q-head), loops over the kv tiles
//   its rows can see, with dQ in registers, and writes dQ once.
// CTAs with more tiles to visit are launched first. Each kernel comes in
// two forms, chosen by dtype. fp32 runs CUDA-core FMAs (flash_common.cuh:
// 256 threads of 4 rows x D/16 columns, 64-row tiles): fp32 checks hold it
// to 1e-4, which rules out TF32. bf16 (the training path) runs
// warp-specialised `wgmma` fed by TMA (hopper.cuh, namespace wg), 384
// threads: a producer warpgroup, of which one warp (dQ: one thread) streams
// tiles through a ring in shared memory (128-byte swizzled, full / empty
// mbarriers), and two consumer warpgroups of 64 rows each; setmaxnreg moves
// registers from the producer to the consumers. No operand is staged
// transposed: a tile read K-major by one product is read MN-major, with the
// transpose bit, by the next.
// - dK/dV: 128 keys a CTA (k and v loaded once), a 2-stage ring of q and
//   dO tiles (64 rows) with lse and delta beside them. Per q tile a
//   consumer computes s^T = k q^T and dp^T = v dO^T (A = k or v, B = q or
//   dO, both K-major), then p^T and ds^T in registers, packs them to bf16
//   as register A operands, and accumulates dV += p^T dO and dK += ds^T q
//   with B = dO or q read MN-major.
// - dQ: 128 q rows a CTA (q and dO loaded once, lse and delta in the
//   registers of the threads that hold their rows), a 3-stage ring of
//   64-key k and v tiles. Per tile a consumer computes S = q k^T and
//   dP = dO v^T (SS, all K-major) as two commit groups, so p is computed
//   while dP is in flight, then ds in registers, packed to bf16 as the A
//   operand of dQ += ds k, whose B is the same k tile read MN-major.

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
constexpr int kThreads = dstpu::hopper::kWsThreads;
using dstpu::hopper::kLog2e;
using dstpu::hopper::kPanel;

// Shared layout (from a 1024-byte aligned base): k, v of the CTA's keys
// ([2 halves][D/64 panels] each), then kStages stages of (q, dO [D/64
// panels] each, lse and delta [64] fp32), then the barriers.
__host__ __device__ constexpr int kv_bytes(int d) { return 2 * (d / 64) * kPanel; }
__host__ __device__ constexpr int stage_bytes(int d) { return 2 * (d / 64) * kPanel + 1024; }
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return 1024 + 2 * (size_t)kv_bytes(d) + (size_t)kStages * stage_bytes(d) + 8 * (2 * kStages + 1);
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
        hw::wgmma_ss_m64n64(st, kdesc + hw::kstep(t), qdesc + hw::kstep(t), t > 0);
      hw::wgmma_commit();
#pragma unroll
      for (int t = 0; t < D / 16; ++t)
        hw::wgmma_ss_m64n64(dpt, vdesc + hw::kstep(t), dodesc + hw::kstep(t), t > 0);
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
      for (int t = 0; t < 4; ++t) hw::wgmma_rs_tb<D>(dv_acc, pa[t], dodesc_t + t * (2048 >> 4));
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
      for (int t = 0; t < 4; ++t) hw::wgmma_rs_tb<D>(dk_acc, da[t], qdesc_t + t * (2048 >> 4));
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

// ------------------------------------------------ bf16 dQ: wgmma
constexpr int kDqRows = 128;   // q rows of a dQ CTA: two consumer warpgroups of 64
constexpr int kDqKeys = 64;    // keys of a dQ ring stage
constexpr int kDqStages = 3;   // dQ ring depth
using DqRing = dstpu::hopper::Ring<kDqStages>;

// Shared layout of the dQ kernel (from a 1024-byte aligned base): q and dO
// ([2 halves][D/64 panels] each), then the ring of (k, v [D/64 panels]
// each) and its barriers, then the barrier of q and dO.
__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return 1024 + 4 * (size_t)(d / 64) * kPanel + DqRing::footprint(2 * (d / 64) * kPanel) + 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, Strides sdq,
                      int batch, int hq, int hkv, int n_q, int n_kv, int causal, float scale) {
  namespace hw = dstpu::hopper;
  constexpr int NP = D / 64;  // 64-column panels of a row
  constexpr int KT = NP * kPanel;  // bytes of a 64-row tile (k, v, half of q or dO)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hw::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t dos = base + 2 * KT;
  const DqRing ring = DqRing::at(base + 4 * KT, 2 * KT);  // tile n: k, then v
  const uint32_t q_bar = ring.end();

  // the forward's CTA order and ring of k and v tiles
  const hw::QTile tile = hw::q_tile_longest_first(kDqRows, n_q, hq, batch);
  const int q0 = tile.q0, h = tile.h, b = tile.b;
  const int kvh = h / (hq / hkv);
  const int n_kt = dstpu::flash::key_tiles(q0, kDqRows, n_q, n_kv, causal, kDqKeys);

  if (threadIdx.x == 0) {
    ring.init();
    hw::mbar_init(q_bar, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads q and dO, then keeps the
    // ring of k and v tiles full
    hw::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    hw::mbar_arrive_tx(q_bar, 4 * KT);
    hw::tma_load_tiles(qs, &tm_q, q_bar, NP, 2, q0, h, b);
    hw::tma_load_tiles(dos, &tm_do, q_bar, NP, 2, q0, h, b);
    for (int n = 0; n < n_kt; ++n) {
      const uint32_t bar = ring.acquire(n);
      hw::tma_load_tiles(ring.stage(n), &tm_k, bar, NP, 1, n * kDqKeys, kvh, b);
      hw::tma_load_tiles(ring.stage(n) + KT, &tm_v, bar, NP, 1, n * kDqKeys, kvh, b);
    }
    return;
  }

  // ---- consumer warpgroups: q rows row0 .. row0 + 63, dQ in registers
  hw::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = q0 + 64 * cw;
  const int r_lo = row0 + 16 * warp + g;  // the thread's rows: r_lo and r_lo + 8
  const int n_mine = min(n_kt, dstpu::flash::key_tiles(row0, 64, n_q, n_kv, causal, kDqKeys));
  // the thread's two rows of lse (in log2 units) and delta, held for the loop
  const long long rb = ((long long)b * hq + h) * n_q;
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    lse2[half] = r < n_q ? lse[rb + r] * kLog2e : 0.f;
    dlt[half] = r < n_q ? delta[rb + r] : 0.f;
  }
  const uint64_t qdesc = hw::desc_sw128(qs + cw * KT, 16, 1024);
  const uint64_t dodesc = hw::desc_sw128(dos + cw * KT, 16, 1024);
  const float scale_log2 = scale * kLog2e;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  hw::mbar_wait(q_bar, 0);

  for (int n = 0; n < n_mine; ++n) {
    ring.wait_loaded(n);
    const uint32_t kd = ring.stage(n);
    const uint64_t kdesc = hw::desc_sw128(kd, 16, 1024);
    const uint64_t vdesc = hw::desc_sw128(kd + KT, 16, 1024);
    // S = q k^T and dP = dO v^T: 64 rows x 64 keys, depth D, one commit
    // group each, so p is computed while dP is in flight
    float sc[kDqKeys / 2], dp[kDqKeys / 2];  // the first k-step overwrites them
    hw::wgmma_fence();
#pragma unroll
    for (int t = 0; t < D / 16; ++t)
      hw::wgmma_ss_m64n64(sc, qdesc + hw::kstep(t), kdesc + hw::kstep(t), t > 0);
    hw::wgmma_commit();
#pragma unroll
    for (int t = 0; t < D / 16; ++t)
      hw::wgmma_ss_m64n64(dp, dodesc + hw::kstep(t), vdesc + hw::kstep(t), t > 0);
    hw::wgmma_commit();
    hw::wgmma_wait<1>();
    hw::fence_regs(sc);

    // p = exp(s scale - lse); only tiles on the diagonal or the keys' ragged
    // end hide keys
    const int k0 = n * kDqKeys;
    const bool edge = k0 + kDqKeys > n_kv || (causal && k0 + kDqKeys - 1 > row0);
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) {
      const int half = hw::acc_half(i);
      const float p = exp2f(fmaf(sc[i], scale_log2, -lse2[half]));
      sc[i] = edge && hidden(r_lo + 8 * half, k0 + hw::acc_col(i, c), n_q, n_kv, causal) ? 0.f : p;
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(dp);

    // ds = p (dp - delta) scale, packed to bf16 as the A operand (64 rows x
    // 16 keys a k-step) of dQ += ds k, whose B = k is read MN-major: the k
    // tile S read K-major serves, with the transpose bit, as [keys][D]
    uint32_t da[kDqKeys / 16][4];
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) sc[i] = dq_score(sc[i], dp[i], dlt[hw::acc_half(i)], scale);
#pragma unroll
    for (int t = 0; t < kDqKeys / 16; ++t) hw::acc_to_a(da[t], sc, t);
    const uint64_t kdesc_t = hw::desc_sw128(kd, kPanel, 1024);
    hw::wgmma_fence();
#pragma unroll
    for (int t = 0; t < kDqKeys / 16; ++t) hw::wgmma_rs_tb<D>(dq_acc, da[t], kdesc_t + t * (2048 >> 4));
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dq_acc);
    ring.release(n);  // stage consumed
  }
  ring.hand_back(n_mine, n_kt);  // tiles only the other warpgroup's rows see

  // rows r_lo + 8 half, columns 8 j + 2 c (+ 1), written once: no atomics
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r < n_q)
      hw::store_row_bf16<D>(dq + b * sdq.b + h * sdq.h + (long long)r * sdq.s + 2 * c, dq_acc,
                            half, 1.f);
  }
}

}  // namespace wg

constexpr size_t dkdv_smem_bytes(int d) { return dstpu::flash::smem_bytes(d, 4, 2, 2); }
constexpr size_t dq_smem_bytes(int d) { return dstpu::flash::smem_bytes(d, 4, 1, 2); }

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
cudaError_t launch_dkdv_wgmma(const Args& a, const unsigned long long* layouts,
                              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap maps[4];  // q, k, v, dO
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (int t = 0; t < 4; ++t) {
    cudaError_t err = dstpu::hopper::tensor_map(&maps[t], ptrs[t], layouts + 7 * t);
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
cudaError_t launch_dq_wgmma(const Args& a, const unsigned long long* layouts,
                            cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap maps[4];  // q, k, v, dO
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (int t = 0; t < 4; ++t) {
    cudaError_t err = dstpu::hopper::tensor_map(&maps[t], ptrs[t], layouts + 7 * t);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = wg::dq_smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(wg::flash_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.n_q + wg::kDqRows - 1) / wg::kDqRows * a.hq * a.b;
  wg::flash_dq_wgmma_kernel<D><<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.st[4], a.b, a.hq, a.hkv,
      a.n_q, a.n_kv, a.causal, a.scale);
  return cudaGetLastError();
}

// layouts: the bf16 kernels' tensor maps (q, k, v, dO), else unused
cudaError_t dispatch(bool dkdv, const Args& a, int d, int dtype,
                     const unsigned long long* layouts, cudaStream_t s) {
  if (dtype == 0 && d == 64) return dkdv ? launch_dkdv<float, 64>(a, s) : launch_dq<float, 64>(a, s);
  if (dtype == 0 && d == 128) return dkdv ? launch_dkdv<float, 128>(a, s) : launch_dq<float, 128>(a, s);
  if (dtype == 1 && d == 64)
    return dkdv ? launch_dkdv_wgmma<64>(a, layouts, s) : launch_dq_wgmma<64>(a, layouts, s);
  if (dtype == 1 && d == 128)
    return dkdv ? launch_dkdv_wgmma<128>(a, layouts, s) : launch_dq_wgmma<128>(a, layouts, s);
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
// layouts (bf16 only): as dstpu_flash_dkdv's (28 values).
extern "C" int dstpu_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              const long long* strides, const unsigned long long* layouts,
                              int b, int n_q, int n_kv, int hq, int hkv, int d, int causal,
                              float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, dout, lse, delta, strides, 5, b, n_q, n_kv, hq, hkv, causal, scale);
  a.dq = dq;
  return (int)dispatch(false, a, d, dtype, layouts, static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (wgmma kernels)
extern "C" size_t dstpu_flash_dkdv_smem_bytes(int d, int dtype) {
  return dtype == 1 ? wg::smem_bytes(d) : dkdv_smem_bytes(d);
}
extern "C" size_t dstpu_flash_dq_smem_bytes(int d, int dtype) {
  return dtype == 1 ? wg::dq_smem_bytes(d) : dq_smem_bytes(d);
}
