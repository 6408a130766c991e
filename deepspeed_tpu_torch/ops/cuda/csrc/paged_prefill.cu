// Tiled SplitFuse prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py:135
// `_prefill_kernel` (reached through `ragged_prefill_attention`): tile c
// holds CT query tokens of ONE sequence at positions pos0 .. pos0+valid-1;
// rows past `valid` are padding and an all-pad tile has valid == 0. Causal
// mask kpos <= qpos plus the pad-row mask; pad rows and all-pad tiles give
// ZEROS, exactly as the Pallas kernel does (the XLA fallback at
// ops/attention.py:220-228 does not: its pad rows attend the scratch block).
//
// What bounds it on the H100: the bytes. At CT = 128 each K/V block fetched
// is used by 128 x rep query rows, 4 flops per visible key, head and head
// dimension: about 137 flops a byte at Llama-3-8B, under the card's ridge
// (~295 for bf16 tensor cores). So the design keeps the tensor cores fed and
// the loads in flight rather than counting flops.
//
// Design: the TPU kernel keeps an fp32 [Hkv, CT*rep, D] accumulator in VMEM
// (2 MB for Llama-3-8B at CT = 128), which no Hopper CTA can hold. Row r of
// a tile's GQA group is query token r / rep and head h*rep + r % rep, as in
// the TPU kernel, and the rows are split across CTAs.
// - bf16 (the serving path): one CTA of 8 warps per (tile, KV head,
//   128-row chunk); warp w owns 16 rows. Both products run on the tensor
//   cores (mma.sync m16n8k16, fp32 accumulators): S = Q K^T with Q and K
//   read by ldmatrix from row-major shared tiles, and P V with P from
//   registers and V read by ldmatrix.trans, so nothing is staged
//   transposed. The scores never leave registers; the online softmax keeps
//   a row's max and sum in the 4 lanes of a quad. P is split into
//   p_hi + p_lo (two bf16 products), so P V keeps ~16 bits of p and the
//   result stays as close to the fp32 plain version as the decode kernel's.
//   K and V stream 32 keys a step (one block, several blocks, or part of
//   one) through a 3-stage ring of cp.async copies: a stage's `full`
//   mbarrier completes when every thread's copies into it have landed, its
//   `empty` mbarrier when every thread is done reading it, so the copies of
//   step j + 2 are in flight while step j is computed. Blocks past the chunk's last visible
//   one are never read (their table entries may be stale); keys there are
//   zero-filled and masked. A head dim below a power of two >= 16 is
//   zero-padded in shared memory. The CTAs are ordered by their number of
//   key steps, most first (each CTA ranks the work items itself).
// - fp32: the CUDA-core kernel of paged_common.cuh (`attend_rows`), one CTA
//   per (tile, KV head, 64-row chunk), 4 head dims a lane up to d = 128 and
//   8 up to 256: fp32 checks hold it to 1e-4, which rules out TF32 tensor
//   cores.

#include "flash_mma.cuh"
#include "hopper.cuh"
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kThreads / 32 * kRowsPerWarp;  // 64 query rows per CTA

// DPL: head dims a lane holds (d <= 32 DPL)
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ tile_slot,
                     const int* __restrict__ tile_pos0, const int* __restrict__ tile_valid,
                     const int* __restrict__ block_tables, int bt_stride, T* __restrict__ out,
                     int hq, int hkv, int d, int bs, int ct, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int rep = hq / hkv;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, ct * rep - row0);
  const dstpu::Smem s = dstpu::carve(smem_raw, kRows, bs, d);
  const int pos0 = tile_pos0[tile];
  const int valid = tile_valid[tile];
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int gr = row0 + r;
    const int qi = gr / rep;
    s.row_off[r] = r < rows ? ((long long)(tile * ct + qi) * hq + h * rep + gr % rep) * d : -1;
    s.row_pos[r] = r < rows && qi < valid ? pos0 + qi : -1;
  }
  // last valid query token of this chunk; none valid -> no block is read
  const int last_qi = min((row0 + rows - 1) / rep, valid - 1);
  const int n_blocks = last_qi >= row0 / rep ? (pos0 + last_qi) / bs + 1 : 0;
  const int* table_row = block_tables + (long long)tile_slot[tile] * bt_stride;
  dstpu::attend_rows<T, kRowsPerWarp, DPL>(q, out, k_pool, v_pool, table_row, n_blocks, bs,
                                           hkv, d, h, scale, s);
}

template <int DPL>
cudaError_t launch_fp32(const void* q, const void* k_pool, const void* v_pool,
                        const void* tile_slot, const void* tile_pos0, const void* tile_valid,
                        const void* block_tables, int bt_stride, void* out, int n_tiles, int hq,
                        int hkv, int d, int bs, int ct, float scale, cudaStream_t stream) {
  const size_t smem = dstpu::smem_bytes(kRows, bs, d);
  cudaError_t err = dstpu::allow_smem(paged_prefill_kernel<float, DPL>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (ct * (hq / hkv) + kRows - 1) / kRows;
  const dim3 grid(n_tiles, hkv, chunks);
  paged_prefill_kernel<float, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tile_slot),
      static_cast<const int*>(tile_pos0), static_cast<const int*>(tile_valid),
      static_cast<const int*>(block_tables), bt_stride, static_cast<float*>(out), hq, hkv, d,
      bs, ct, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // GQA rows of a CTA
constexpr int kKeys = 32;           // keys of a step
constexpr int kStages = 3;          // cp.async ring depth

// shared bytes: q rows, then the ring of [k | v][kKeys] rows, all dp + 8
// bf16 apart (the 8 rows an ldmatrix reads then fall in distinct banks);
// the launch adds one int per work item (its key steps)
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)(dp + 8) * (kRows + 2 * kStages * kKeys);
}

// Key steps of work item `item` = (tile, chunk of kRows rows): enough to
// cover keys 0 .. the position of the chunk's last valid token; 0 when the
// chunk holds no valid token.
__device__ __forceinline__ int item_steps(int item, int chunks, int rep, int ct,
                                          const int* __restrict__ tile_pos0,
                                          const int* __restrict__ tile_valid, int* last_pos) {
  const int tile = item / chunks;
  const int row0 = (item - tile * chunks) * kRows;
  const int row_end = min(row0 + kRows, ct * rep);
  const int last_tok = min((row_end - 1) / rep, tile_valid[tile] - 1);
  if (last_tok < row0 / rep) return 0;
  *last_pos = tile_pos0[tile] + last_tok;
  return *last_pos / kKeys + 1;
}

// two fp32 values as bf16 pairs hi and lo with hi + lo ~ (x, y) to ~16 bits
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// DP: the head dim d padded to 16, 32, 64, 128 or 256 (zeros in shared
// memory); at 256 the accumulators take a CTA's share of two a SM
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
paged_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                        const bf16* __restrict__ v_pool, const int* __restrict__ tile_slot,
                        const int* __restrict__ tile_pos0, const int* __restrict__ tile_valid,
                        const int* __restrict__ block_tables, int bt_stride,
                        bf16* __restrict__ out, int n_tiles, int hq, int hkv, int d, int bs,
                        int ct, float scale) {
  namespace hw = dstpu::hopper;
  namespace mm = dstpu::flash::mma;
  constexpr int LD = DP + 8;   // shared row stride, bf16
  constexpr int CH = DP / 8;   // 16-byte chunks of a row
  constexpr int NT = DP / 8;   // 8-wide n tiles of the output
  constexpr int STAGE = 2 * kKeys * LD * 2;  // bytes of one ring stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_item;
  // per stage: full (its copies landed, one cp.async arrival a thread) and
  // empty (every thread is done with it)
  __shared__ __align__(8) uint64_t s_bar[2 * kStages];
  const uint32_t qs = hw::smem_addr(smem_raw);
  const uint32_t ring = qs + kRows * LD * 2;
  const uint32_t full = hw::smem_addr(s_bar);
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int rep = hq / hkv;
  const int chunks = (ct * rep + kRows - 1) / kRows;
  const int n_items = n_tiles * chunks;
  const int h = blockIdx.x % hkv;

  // this CTA's work item: rank blockIdx.x / hkv when the items are ordered
  // by key steps, most first (ties by index)
  int* costs = reinterpret_cast<int*>(smem_raw + smem_bytes(DP));
  if (tid == 0) {
    for (int i = 0; i < 2 * kStages; ++i) hw::mbar_init(full + 8 * i, kThreads);
    hw::mbar_fence_init();
  }
  for (int it = tid; it < n_items; it += kThreads) {
    int unused;
    costs[it] = item_steps(it, chunks, rep, ct, tile_pos0, tile_valid, &unused);
  }
  __syncthreads();
  for (int it = tid; it < n_items; it += kThreads) {
    const int cost = costs[it];
    int rank = 0;
    for (int o = 0; o < n_items; ++o) rank += costs[o] > cost || (costs[o] == cost && o < it);
    if (rank == (int)blockIdx.x / hkv) s_item = it;
  }
  __syncthreads();
  const int item = s_item;
  const int tile = item / chunks;
  const int row0 = (item - tile * chunks) * kRows;
  const int n_rows = min(kRows, ct * rep - row0);
  const int pos0 = tile_pos0[tile];
  const int valid = tile_valid[tile];
  int last_pos = -1;
  const int n_steps = item_steps(item, chunks, rep, ct, tile_pos0, tile_valid, &last_pos);
  const int last_block = n_steps ? last_pos / bs : -1;
  const int* __restrict__ table = block_tables + (long long)tile_slot[tile] * bt_stride;
  const long long key_stride = (long long)hkv * d;

  // element offset of row r of the chunk in q / out
  auto row_off = [&](int r) {
    const int gr = row0 + r;
    return ((long long)(tile * ct + gr / rep) * hq + h * rep + gr % rep) * d;
  };

  // q rows of the chunk; pad rows and columns past d are zeros
  if (n_steps) {
    for (int i = tid; i < kRows * CH; i += kThreads) {
      const int r = i / CH;
      const int cc = i - r * CH;
      const bool ok = r < n_rows && (row0 + r) / rep < valid && cc * 8 < d;
      hw::cp_async16(qs + (r * LD + cc * 8) * 2, ok ? q + row_off(r) + cc * 8 : q, ok);
    }
  }

  // keys j * kKeys .. + kKeys - 1 into ring stage j % kStages
  auto load_step = [&](int j) {
    const uint32_t kdst = ring + (j % kStages) * STAGE;
    const uint32_t vdst = kdst + kKeys * LD * 2;
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int r = i / CH;
      const int cc = i - r * CH;
      const int kpos = j * kKeys + r;
      const int blk = kpos / bs;
      const bool ok = blk <= last_block && cc * 8 < d;
      long long off = 0;
      if (ok) off = ((long long)table[blk] * bs + (kpos - blk * bs)) * key_stride + h * d + cc * 8;
      hw::cp_async16(kdst + (r * LD + cc * 8) * 2, k_pool + off, ok);
      hw::cp_async16(vdst + (r * LD + cc * 8) * 2, v_pool + off, ok);
    }
  };
  // steps 0 .. kStages - 2 in flight (step 0's barrier also covers q)
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps) {
      load_step(j);
      hw::cp_async_arrive(full + 8 * j);
    }
  }

  // the warp's rows g and g + 8: query position, or -1 for a pad row
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const int tok = (row0 + r) / rep;
    qpos[i] = r < n_rows && tok < valid ? pos0 + tok : -1;
  }
  const int warp_last = __reduce_max_sync(0xffffffffu, max(qpos[0], qpos[1]));
  float m[2] = {dstpu::kNegInf, dstpu::kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  // one step: keys j * kKeys .. + kKeys - 1 for the warp's 16 rows
  auto attend_step = [&](int j) {
    const uint32_t ks = ring + (j % kStages) * STAGE;
    const uint32_t vs = ks + kKeys * LD * 2;

    // S = Q K^T: 16 rows x 32 keys, four 8-key tiles
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < DP / 16; ++t) {
      uint32_t a[4];
      hw::ldsm_x4(a, qs + ((warp * 16 + (lane & 15)) * LD + 16 * t + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        hw::ldsm_x4(b, ks + ((16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * t +
                             ((lane >> 3) & 1) * 8) * 2);
        mm::mma16816(s[2 * np], a, b[0], b[1]);
        mm::mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // mask, online softmax (log2 domain); a row's values live in a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j * kKeys + 8 * n + 2 * c + (e & 1);
        const float x = kpos <= qpos[e >> 1] ? s[n][e] * scale_log2 : dstpu::kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = mm::quad_max(mx[i]);
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + mm::quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // acc += P V over two 16-key k-steps, P = p_hi + p_lo
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      uint32_t hi[4], lo[4];
      split2(s[2 * t][0], s[2 * t][1], hi[0], lo[0]);
      split2(s[2 * t][2], s[2 * t][3], hi[1], lo[1]);
      split2(s[2 * t + 1][0], s[2 * t + 1][1], hi[2], lo[2]);
      split2(s[2 * t + 1][2], s[2 * t + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        hw::ldsm_x4_t(b, vs + ((16 * t + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 16 * np +
                               (lane >> 4) * 8) * 2);
        mm::mma16816(acc[2 * np], hi, b[0], b[1]);
        mm::mma16816(acc[2 * np], lo, b[0], b[1]);
        mm::mma16816(acc[2 * np + 1], hi, b[2], b[3]);
        mm::mma16816(acc[2 * np + 1], lo, b[2], b[3]);
      }
    }
  };

  for (int j = 0; j < n_steps; ++j) {
    // refill the stage of step j - 1 with step j + kStages - 1 once every
    // thread is done with it; then wait for step j's copies
    const int jn = j + kStages - 1;
    if (jn < n_steps) {
      if (j > 0) hw::mbar_wait(empty + 8 * ((j - 1) % kStages), ((j - 1) / kStages) & 1);
      load_step(jn);
      hw::cp_async_arrive(full + 8 * (jn % kStages));
    }
    hw::mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
    if (warp_last >= j * kKeys)  // some row of the warp sees these keys
      attend_step(j);
    hw::mbar_arrive(empty + 8 * (j % kStages));
  }

  // rows of the chunk: acc / l, or zeros for a pad row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= n_rows) continue;
    const bool live = qpos[i] >= 0;
    const float inv = live ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
    bf16* dst = out + row_off(r) + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
            live ? acc[n][2 * i] * inv : 0.f, live ? acc[n][2 * i + 1] * inv : 0.f);
  }
}

int padded_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

template <int DP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tile_slot,
                   const void* tile_pos0, const void* tile_valid, const void* block_tables,
                   int bt_stride, void* out, int n_tiles, int hq, int hkv, int d, int bs, int ct,
                   float scale, cudaStream_t stream) {
  const int chunks = (ct * (hq / hkv) + kRows - 1) / kRows;
  const size_t smem = smem_bytes(DP) + sizeof(int) * n_tiles * chunks;
  cudaError_t err = dstpu::allow_smem(paged_prefill_tc_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  paged_prefill_tc_kernel<DP><<<n_tiles * chunks * hkv, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(tile_slot),
      static_cast<const int*>(tile_pos0), static_cast<const int*>(tile_valid),
      static_cast<const int*>(block_tables), bt_stride, static_cast<bf16*>(out), n_tiles, hq,
      hkv, d, bs, ct, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* tile_slot, const void* tile_pos0, const void* tile_valid,
                     const void* block_tables, int bt_stride, void* out, int n_tiles, int hq,
                     int hkv, int d, int bs, int ct, float scale, cudaStream_t stream) {
  if (d > 256 || d % 8) return cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 16:
      return launch<16>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                        bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, stream);
    case 32:
      return launch<32>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                        bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, stream);
    case 64:
      return launch<64>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                        bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, stream);
    case 128:
      return launch<128>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                         bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, stream);
    default:
      return launch<256>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                         bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, stream);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a
// cudaError_t (0 = launched).
extern "C" int dstpu_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tile_slot, const void* tile_pos0,
                                   const void* tile_valid, const void* block_tables,
                                   int bt_stride, void* out, int n_tiles, int hq, int hkv,
                                   int d, int bs, int ct, float scale, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (d > 256 || d % 4))
    err = cudaErrorInvalidValue;
  else if (dtype == 0 && d <= 128)
    err = launch_fp32<4>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                         bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, st);
  else if (dtype == 0)
    err = launch_fp32<8>(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                         bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, st);
  else if (dtype == 1)
    err = tc::dispatch(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid, block_tables,
                       bt_stride, out, n_tiles, hq, hkv, d, bs, ct, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" size_t dstpu_paged_prefill_smem_bytes(int d, int bs, int dtype) {
  return dtype == 1 ? tc::smem_bytes(tc::padded_dim(d)) : dstpu::smem_bytes(kRows, bs, d);
}
