// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py:40
// `_fwd_kernel` (reached through `_flash_fwd` and `flash_attention`):
// causal or full attention with an online softmax, returning o in q's dtype
// and lse = m + log(l) in fp32 [B, Hq, Sq], in natural-log units of the
// scaled scores. Same arithmetic as the Pallas kernel: masked scores are
// -1e30, the causal mask is q_pos >= k_pos counted from 0 on both sides
// (aligned at the top left, also when Sq != Skv), and l is floored at 1e-30.
//
// What bounds it on the H100: at the training shapes (S = 4096, D = 128) it
// does 4 flops per visible (query, key) pair and head dim against 2 bytes per
// element of q, k, v, o read or written once: about 1600 flops a byte, far
// above the card's ridge, so the bound is the tensor cores' rate (2.75e11
// flops, 0.278 ms at the training cell's attention).
//
// Design: the TPU kernel walks a sequential (q block, kv block) grid,
// carrying m, l and the accumulator in VMEM scratch from one grid step to
// the next. Hopper CTAs run in no order, so one CTA owns a q tile for one
// (batch, head) and loops itself over the kv tiles it can see (all of them,
// or under the causal mask only those up to the tile's last row): tiles
// strictly above the diagonal are never loaded. GQA maps head h to kv head
// h / (Hq / Hkv) without replicating k or v. CTAs with more visible kv tiles
// are launched first, the q-heads of a GQA group side by side (their k and v
// tiles meet in L2). Two kernels, chosen by dtype and head dim:
// - bf16 at d = 64 or 128 (the training path, namespace fw): warp-
//   specialised `wgmma` fed by TMA (hopper.cuh). 384 threads: a producer
//   warpgroup, of which one thread
//   loads the CTA's 128 q rows once and keeps TMA loads of the next 64-key
//   k and v tiles in flight in a 4-stage ring (full / empty mbarriers), and
//   two consumer warpgroups of 64 q rows each. A consumer computes
//   S = q k^T by SS wgmma (q and k K-major, 128-byte swizzled), the online
//   softmax in registers in log2 units (exp2, the scale folded in), and
//   O += P v with P packed to bf16 as the register A operand and v read
//   MN-major with the transpose bit: nothing is staged transposed. S of the
//   next tile is issued before P v of this one, so its softmax overlaps the
//   product in flight. setmaxnreg moves registers to the consumers.
// - fp32, and bf16 at every other head dim: CUDA-core FMAs in fp32
//   throughout (flash_common.cuh, bf16 widened as it is staged), 256 threads
//   each holding 4 rows x D/16 columns of the padded head dim D (64, 128 or
//   256); q is scaled before the dot, as the Pallas kernel does. fp32 checks
//   hold it to 1e-4, which rules out TF32.

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "hopper.cuh"

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
                 Strides so, int hq, int hkv, int n_q, int n_kv, int d, int causal,
                 float scale) {
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

  fl::load_tile<T, D>(qs, q, sq, b, h, q0, n_q, d, scale);

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
    fl::load_tile<T, D>(ks, k, sk, b, kvh, k0, n_kv, d, 1.f);
    fl::load_tile<T, D>(vs, v, sv, b, kvh, k0, n_kv, d, 1.f);
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
  fl::store_rows<T, G>(o, so, b, h, q0, n_q, d, acc, inv, ty, tx);
}

// ------------------------------------------------ bf16: wgmma, TMA ring
namespace fw {

using bf16 = __nv_bfloat16;
using dstpu::hopper::kLog2e;
using dstpu::hopper::kPanel;
constexpr int kRows = 128;     // q rows of a CTA: two consumer warpgroups of 64
constexpr int kKeys = 64;      // keys of a ring stage
constexpr int kStages = 4;     // ring depth
constexpr float kLn2 = 0.6931471805599453f;
using Ring = dstpu::hopper::Ring<kStages>;

// Shared layout (from a 1024-byte aligned base): q ([2 halves][D/64
// panels]), then the ring of (k, v [D/64 panels] each) and its barriers,
// then q's barrier.
__host__ __device__ constexpr int tile_bytes(int d) { return (d / 64) * kPanel; }
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return 1024 + 2 * (size_t)tile_bytes(d) + Ring::footprint(2 * tile_bytes(d)) + 8;
}

template <int D>
__global__ void __launch_bounds__(dstpu::hopper::kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                       float* __restrict__ lse, Strides so, int batch, int hq, int hkv, int n_q,
                       int n_kv, int causal, float scale) {
  namespace hw = dstpu::hopper;
  namespace mm = dstpu::flash::mma;
  constexpr int NP = D / 64;  // 64-column panels of a row
  constexpr int KT = tile_bytes(D);  // bytes of a 64-row tile (k, v, half of q)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hw::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base;
  const Ring ring = Ring::at(base + 2 * KT, 2 * KT);  // tile n: k, then v
  const uint32_t q_bar = ring.end();

  const hw::QTile tile = hw::q_tile_longest_first(kRows, n_q, hq, batch);
  const int q0 = tile.q0, h = tile.h, b = tile.b;
  const int kvh = h / (hq / hkv);
  // the key tiles the ring carries: those the CTA's last row sees
  const int n_kt = dstpu::flash::key_tiles(q0, kRows, n_q, n_kv, causal, kKeys);

  if (threadIdx.x == 0) {
    ring.init();
    hw::mbar_init(q_bar, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads q, then keeps the ring full
    hw::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    hw::mbar_arrive_tx(q_bar, 2 * KT);
    hw::tma_load_tiles(qs, &tm_q, q_bar, NP, 2, q0, h, b);
    for (int n = 0; n < n_kt; ++n) {
      const uint32_t bar = ring.acquire(n);
      hw::tma_load_tiles(ring.stage(n), &tm_k, bar, NP, 1, n * kKeys, kvh, b);
      hw::tma_load_tiles(ring.stage(n) + KT, &tm_v, bar, NP, 1, n * kKeys, kvh, b);
    }
    return;
  }

  // ---- consumer warpgroups: q rows row0 .. row0 + 63, O in registers
  hw::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = q0 + 64 * cw;
  const int r_lo = row0 + 16 * warp + g;  // the thread's rows: r_lo and r_lo + 8
  // the tiles this warpgroup's rows see: a prefix of the ring's
  const int n_mine = min(n_kt, dstpu::flash::key_tiles(row0, 64, n_q, n_kv, causal, kKeys));
  const uint64_t qdesc = hw::desc_sw128(qs + cw * KT, 16, 1024);
  const float scale_log2 = scale * kLog2e;  // scores to log2 units

  float o_acc[D / 2], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  // running max of the raw scores and this thread's part of the row sums
  float m[2] = {dstpu::kNegInf, dstpu::kNegInf}, l[2] = {0.f, 0.f};

  // S = q k^T of tile n (64 rows x 64 keys, depth D): one commit group
  auto issue_s = [&](int n) {
    const uint64_t kdesc = hw::desc_sw128(ring.stage(n), 16, 1024);
#pragma unroll
    for (int t = 0; t < D / 16; ++t)
      hw::wgmma_ss_m64n64(s, qdesc + hw::kstep(t), kdesc + hw::kstep(t), t > 0);
    hw::wgmma_commit();
  };
  // the online softmax of tile n's scores: s becomes p = exp2((s - m) scale
  // log2 e), m and l move on; returns the factors that rescale O
  auto softmax = [&](int n, float (&corr)[2]) {
    const int k0 = n * kKeys;
    // only tiles on the diagonal or the keys' ragged end hide keys
    const bool edge = k0 + kKeys > n_kv || (causal && k0 + kKeys - 1 > row0);
    float mx[2] = {dstpu::kNegInf, dstpu::kNegInf};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int half = hw::acc_half(i);
      if (edge && fwd_hidden(r_lo + 8 * half, k0 + hw::acc_col(i, c), n_kv, causal))
        s[i] = dstpu::kNegInf;
      mx[half] = fmaxf(mx[half], s[i]);
    }
    float ms[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], mm::quad_max(mx[half]));
      corr[half] = exp2f((m[half] - m_new) * scale_log2);
      m[half] = m_new;
      ms[half] = m_new * scale_log2;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int half = hw::acc_half(i);
      s[i] = exp2f(fmaf(s[i], scale_log2, -ms[half]));
      rs[half] += s[i];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + rs[half];
  };
  // O += P v of tile n: P (64 x 64 keys) from s as four register A
  // fragments; B = v [64 keys][D] MN-major, 16 keys (2048 bytes) a k-step
  auto issue_pv = [&](int n, const uint32_t (&pa)[kKeys / 16][4]) {
    const uint64_t vdesc = hw::desc_sw128(ring.stage(n) + KT, kPanel, 1024);
#pragma unroll
    for (int t = 0; t < kKeys / 16; ++t) hw::wgmma_rs_tb<D>(o_acc, pa[t], vdesc + t * (2048 >> 4));
    hw::wgmma_commit();
  };
  // step n: P of tile n is in s; S of tile n + 1 (if `more`) is issued
  // before P v of tile n, and its softmax runs while P v is in flight
  auto step = [&](int n, bool more) {
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int t = 0; t < kKeys / 16; ++t) hw::acc_to_a(pa[t], s, t);
    if (more) ring.wait_loaded(n + 1);
    hw::wgmma_fence();
    if (more) issue_s(n + 1);
    issue_pv(n, pa);
    float corr[2] = {1.f, 1.f};
    if (more) {
      hw::wgmma_wait<1>();
      hw::fence_regs(s);
      softmax(n + 1, corr);
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(o_acc);
    ring.release(n);  // stage consumed
    if (more) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[hw::acc_half(i)];
    }
  };

  hw::mbar_wait(q_bar, 0);
  if (n_mine > 0) {
    ring.wait_loaded(0);
    hw::wgmma_fence();
    issue_s(0);
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    float corr[2];
    softmax(0, corr);  // O is still 0: nothing to rescale
  }
  int n = 0;
  for (; n + 1 < n_mine; ++n) step(n, true);
  if (n_mine > 0) step(n, false);
  ring.hand_back(n_mine, n_kt);  // tiles only the other warpgroup's rows see

  // rows r_lo + 8 half, columns 8 j + 2 c (+ 1); lse in natural-log units
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    const float safe_l = fmaxf(mm::quad_sum(l[half]), 1e-30f);
    const float inv = 1.f / safe_l;
    if (r >= n_q) continue;
    if (c == 0) lse[((long long)b * hq + h) * n_q + r] = (m[half] * scale_log2 + log2f(safe_l)) * kLn2;
    hw::store_row_bf16<D>(o + b * so.b + h * so.h + (long long)r * so.s + 2 * c, o_acc, half, inv);
  }
}

}  // namespace fw

// q, k, v tiles and one score tile
constexpr size_t smem_bytes(int d) {
  return dstpu::flash::smem_bytes(d, 3 * kBlock, kBlock, kBlock, 0);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Strides* st, int b, int n_q, int n_kv, int hq, int hkv, int d,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBlock - 1) / kBlock, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st[0], st[1], st[2], st[3], hq, hkv, n_q, n_kv, d, causal,
      scale);
  return cudaGetLastError();
}

// the CUDA-core kernel at the padded head dim of d
template <typename T>
cudaError_t launch_padded(const void* q, const void* k, const void* v, void* o, float* lse,
                          const Strides* st, int b, int n_q, int n_kv, int hq, int hkv, int d,
                          int causal, float scale, cudaStream_t s) {
  switch (dstpu::flash::padded_dim(d)) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, st, b, n_q, n_kv, hq, hkv, d, causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, st, b, n_q, n_kv, hq, hkv, d, causal, scale, s);
    default:
      return launch<T, 256>(q, k, v, o, lse, st, b, n_q, n_kv, hq, hkv, d, causal, scale, s);
  }
}

// layouts: the tensor maps of q, k, v (7 values each, `tma_layout`)
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         const Strides* st, const unsigned long long* layouts, int b, int n_q,
                         int n_kv, int hq, int hkv, int causal, float scale,
                         cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int t = 0; t < 3; ++t) {
    cudaError_t err = dstpu::hopper::tensor_map(&maps[t], ptrs[t], layouts + 7 * t);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = fw::smem_bytes(D);
  cudaError_t err = dstpu::allow_smem(fw::flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (n_q + fw::kRows - 1) / fw::kRows * hq * b;
  fw::flash_fwd_wgmma_kernel<D><<<grid, dstpu::hopper::kWsThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, st[3], b, hq, hkv, n_q,
      n_kv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v, o in turn.
// layouts (bf16 at d = 64 or 128 only, else unused): the tensor maps of q, k,
// v in turn, each dims (D, S, H, B) then byte strides (S, H, B) (21 values).
// dtype: 0 = float32, 1 = bfloat16; d: a multiple of 8 from 8 to 256 (bf16
// at 64 and 128: the wgmma kernel; else the CUDA-core kernel at the padded
// head dim). Returns a cudaError_t (0 = launched).
extern "C" int dstpu_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               const long long* strides, const unsigned long long* layouts,
                               int b, int n_q, int n_kv, int hq, int hkv, int d, int causal,
                               float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st[4];
  for (int t = 0; t < 4; ++t) st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d < 8 || d > 256 || d % 8)
    err = cudaErrorInvalidValue;
  else if (dtype == 1 && d == 64)
    err = launch_wgmma<64>(q, k, v, o, l, st, layouts, b, n_q, n_kv, hq, hkv, causal, scale, s);
  else if (dtype == 1 && d == 128)
    err = launch_wgmma<128>(q, k, v, o, l, st, layouts, b, n_q, n_kv, hq, hkv, causal, scale, s);
  else if (dtype == 0)
    err = launch_padded<float>(q, k, v, o, l, st, b, n_q, n_kv, hq, hkv, d, causal, scale, s);
  else if (dtype == 1)
    err = launch_padded<__nv_bfloat16>(q, k, v, o, l, st, b, n_q, n_kv, hq, hkv, d, causal,
                                       scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (the wgmma kernel at d = 64 or 128)
extern "C" size_t dstpu_flash_fwd_smem_bytes(int d, int dtype) {
  return dtype == 1 && (d == 64 || d == 128) ? fw::smem_bytes(d)
                                             : smem_bytes(dstpu::flash::padded_dim(d));
}
