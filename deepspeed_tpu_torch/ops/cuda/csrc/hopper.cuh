// Hopper (sm_90a) building blocks of the kernels that stream their
// operands asynchronously (paged_decode.cu, paged_prefill.cu, flash_fwd.cu,
// flash_bwd.cu):
//
// - cp.async: 16-byte copies global -> shared that bypass registers, zero
//   filled where the source is out of range, their completion tracked by
//   an mbarrier or by commit groups;
// - ldmatrix: four 8 x 8 bf16 tiles from shared memory into the fragment
//   layout of mma.sync (optionally transposed, so an operand whose other
//   index is contiguous needs no transposed copy);
// - mbarriers: arrival counts plus transaction bytes; a producer and its
//   consumers hand the stages of a ring to each other by phase parity
//   (`Ring`: one producer thread, the two consumer warpgroups of a
//   warp-specialised CTA);
// - TMA: one thread copies a [64 rows][64 bf16] box of a 4-D tensor map
//   (head dim, sequence, head, batch) into shared memory, 128-byte swizzled,
//   and the copy completes on an mbarrier; `tensor_map` encodes such a map
//   on the host;
// - wgmma: a warpgroup (4 warps) multiplies a 64-row tile asynchronously,
//   B (and A) read from shared memory through 64-bit matrix descriptors;
// - setmaxnreg: a producer warpgroup hands registers to its consumers.
//
// Shared tiles read by wgmma are [rows][64 bf16] panels of 128-byte rows,
// swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them (the 16-byte
// chunk index XOR the row index mod 8), each panel 1024-byte aligned. Such a
// panel is K-major for a product whose depth runs along its rows (k
// contiguous) and MN-major, read with the transpose bit, for one whose
// depth runs down its rows.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstpu {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- cp.async
// 16 bytes src -> shared dst; zeros instead when !fill (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
// close this thread's group of cp.async issued so far; wait until at most N
// of its groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// one arrival on mbarrier bar once all of this thread's cp.async so far
// have landed (counts against the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ------------------------------------------------------------- ldmatrix
// Lanes 8 i .. 8 i + 7 give the row addresses of tile i; r[i] is tile i's
// fragment (row lane / 4, columns 2 (lane % 4), +1), or with _t its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` more of transactions (TMA copies) this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of the given parity; an
// arrival that never comes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// The box at coordinates (c0 along the head dim, c1 rows, c2 head, c3
// batch) of `map` into shared dst; completes `bytes` on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -------------------------------------------------------------- setmaxnreg
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- wgmma
// Matrix descriptor of a 128-byte-swizzled shared operand: start address,
// leading byte offset (MN-major: between 64-element column panels; unused
// K-major), stride byte offset (between groups of 8 rows: 1024).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulators across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of a 64 x N wgmma tile (and of mma.sync's 16 x 8
// tiles): warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8 (lane
// = 4 g + c); d[4 j + e] is row 16 w + g + 8 (e / 2), column 8 j + 2 c + e % 2.
// d (64 x 64, fp32) = A B^T + (accumulate ? d : 0) over k = 16: A and B
// K-major, 128-byte swizzled, both read from shared memory through their
// descriptors.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) += A B over k = 16: A (64 x 16 bf16) in registers, in
// the accumulator layout packed to bf16 pairs; B MN-major (its n index
// contiguous, rows of 128 swizzled bytes), read with the transpose bit.
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A B over k = 16: A (64 x 16 bf16) in registers, in
// the accumulator layout packed to bf16 pairs; B MN-major (its n index
// contiguous, rows of 128 swizzled bytes), read with the transpose bit.
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ------------------------------------------- shared by the wgmma kernels
constexpr int kPanel = 64 * 128;  // bytes of a [64 rows][64 bf16] swizzled panel
constexpr float kLog2e = 1.4426950408889634f;
// warp-specialised CTAs: a producer warpgroup, then two consumer warpgroups
constexpr int kWsThreads = 384;
constexpr int kConsumerThreads = 256;

// `tiles` consecutive 64-row tiles of one head of a 4-D tensor map (rows
// row0 on, head h, batch b), each as np column panels, into dst: tile t,
// panel p at dst + (t np + p) kPanel. The copies complete on bar.
__device__ __forceinline__ void tma_load_tiles(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int np, int tiles, int row0, int h, int b) {
  for (int t = 0; t < tiles; ++t)
    for (int p = 0; p < np; ++p)
      tma_load_4d(dst + (t * np + p) * kPanel, map, bar, 64 * p, row0 + 64 * t, h, b);
}

// A ring of Stages stages of `bytes` each in shared memory, from `data` on,
// followed by its barriers full[Stages] and empty[Stages]. Tile n passes
// through stage n % Stages in phase (n / Stages) % 2: one producer thread
// arrives on full with the stage's TMA bytes, and every consumer thread
// (kConsumerThreads) arrives on empty once it no longer reads the stage.
template <int Stages>
struct Ring {
  uint32_t data, bytes, full, empty;

  // shared bytes of a ring of stages of stage_bytes each
  __host__ __device__ static constexpr size_t footprint(size_t stage_bytes) {
    return Stages * (stage_bytes + 16);
  }
  __device__ __forceinline__ static Ring at(uint32_t start, uint32_t stage_bytes) {
    const uint32_t bars = start + Stages * stage_bytes;
    return {start, stage_bytes, bars, bars + 8 * Stages};
  }
  // the first shared byte past the ring
  __device__ __forceinline__ uint32_t end() const { return empty + 8 * Stages; }
  __device__ __forceinline__ uint32_t stage(int n) const { return data + (n % Stages) * bytes; }
  // by one thread, before the CTA's first __syncthreads
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
  }
  // producer: wait for tile n's stage to be free, expect its `bytes` of TMA
  // copies; returns the barrier the copies complete on
  __device__ __forceinline__ uint32_t acquire(int n) const {
    mbar_wait(empty + 8 * (n % Stages), ((n / Stages) & 1) ^ 1);
    mbar_arrive_tx(full + 8 * (n % Stages), bytes);
    return full + 8 * (n % Stages);
  }
  // consumer: wait for tile n, and give its stage back
  __device__ __forceinline__ void wait_loaded(int n) const {
    mbar_wait(full + 8 * (n % Stages), (n / Stages) & 1);
  }
  __device__ __forceinline__ void release(int n) const { mbar_arrive(empty + 8 * (n % Stages)); }
  // consumer: tiles [from, to) that only the other consumers read, handed
  // back unread
  __device__ __forceinline__ void hand_back(int from, int to) const {
    for (int n = from; n < to; ++n) {
      wait_loaded(n);
      release(n);
    }
  }
};

// The CTA's q tile (first row q0), q-head h and batch b, for the kernels
// that give each CTA `rows` rows of one (batch, q-head): the q tiles that
// see the most key tiles (the last, under the causal mask) are launched
// first, and within a q tile the q-heads of a GQA group side by side, so
// their k and v tiles meet in L2.
struct QTile {
  int q0, h, b;
};
__device__ __forceinline__ QTile q_tile_longest_first(int rows, int n_q, int hq, int batch) {
  const int per_qt = hq * batch;
  const int n_qt = (n_q + rows - 1) / rows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
  const int hb = (int)(blockIdx.x % per_qt);
  return {qt * rows, hb % hq, hb / hq};
}

// The thread's row `half` of a 64 x D accumulator tile (columns 8 j + 2 c,
// + 1; see wgmma_ss_m64n64), times mul, as bf16 into `row`, which points at
// column 2 c of the output row.
template <int D>
__device__ __forceinline__ void store_row_bf16(__nv_bfloat16* row, const float (&d)[D / 2],
                                               int half, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
        __floats2bfloat162_rn(d[4 * j + 2 * half] * mul, d[4 * j + 2 * half + 1] * mul);
}

// Descriptor offset (in 16-byte units) of k-step t (16 columns) of a
// K-major [64 rows][D] operand stored as D / 64 panels kPanel apart: 32
// bytes a step inside a panel.
__device__ __forceinline__ uint64_t kstep(int t) { return ((t / 4) * kPanel + (t % 4) * 32) >> 4; }

// d (64 x D, fp32) += A B for one 16-deep k-step: A (64 x 16 bf16) in
// registers, B an MN-major [16 rows][D] slice of D / 64 panels kPanel apart
// (its descriptor's leading byte offset), read with the transpose bit.
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_m64n64_tb(d, a, b);
  else
    wgmma_rs_m64n128_tb(d, a, b);
}

// The A fragment of k-step t (columns 16 t .. 16 t + 15) of a 64-row
// accumulator tile d, packed to bf16 pairs: the accumulator and the A
// operand share their row layout, so scores become the next product's A
// without leaving registers.
template <int M>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[M], int t) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * t + 2 * r], d[8 * t + 2 * r + 1]);
    a[r] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// Accumulator element i of a 64-row wgmma tile lies in the thread's row
// half (i / 2) % 2, column 8 (i / 4) + 2 c + i % 2 (see wgmma_ss_m64n64).
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int c) { return 8 * (i >> 2) + 2 * c + (i & 1); }

// -------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, const unsigned long long* layout) {
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

}  // namespace hopper
}  // namespace dstpu
