// Paged flash-decode attention of T new query tokens against a global KV page
// pool through per-row block tables, for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_paged_pallas
// (the TPU kernel _paged_decode_kernel).  Same function: the pool is
// (n_pages, ps, K, D); row b's table index i names the page that holds
// positions i*ps .. i*ps+ps-1 (positions are written once, never wrapped, so
// no kv_pos pool exists); -1 entries are unset.  Query row r = t*G + g of KV
// head kh sits at q_pos = cache_len - T + t and sees position p iff its page
// is set and p <= q_pos (and p > q_pos - window with a window).  Masked
// scores are -1e30 (not -inf): a row that sees nothing at all gets what the
// plain version's uniform softmax gives, the mean of V over every table
// entry with unset entries read as page 0 (an idle batch row: the mean of
// page 0).  It stays finite.
//
// Bound on this card, at the serving path's largest shapes (qwen3-1.7b, 16
// heads / 8 KV heads, D = 128, bf16, max_context 1024, B = 8):
//   decode/verify, T = 9 over 1024 positions a row: K and V read once,
//     2 * 8 * 1024 * 8 * 128 * 2 B = 33.6 MB -> 10 us at 3.35 TB/s, against
//     0.6 GFLOP -> bytes;
//   admission, T = 1024 over 1024 positions (causal): 34 GFLOP -> 35 us at
//     989 TFLOP/s bf16, against ~100 MB of q, out, K and V -> 30 us; the two
//     are close, operations slightly ahead.
//
// Two kernels; the C entry point picks one from shape and dtype alone
// (decode_attention_paged_route): bf16 with T*G >= PREFILL_MIN_ROWS (32:
// every admission bucket, T >= 16) takes paged_prefill_kernel, everything
// else (decode and verify, T <= 9, and all float32) paged_decode_kernel.
//
// paged_prefill_kernel (bf16 admission): the tensor-core tile loop of
// attention_tile.cuh (SASS: HGMMA.64x64x16.F32.BF16 for S, 64x128x16 for
// PV; chip_smoke.py checks both).  One block per (KV head, batch row, tile
// of 128 query rows r = t*G + g of that head), heaviest causal tiles first;
// two consumer warpgroups of 64 rows share each staged K/V tile (faster
// than one: attention_variants.py).  The tile's rows see positions
// [lo, hi] (the first row's window start to the last row's q_pos, hi
// clamped to P*ps - 1), walked in tiles of 64 positions.  For each tile,
// 64 threads read the block table once and write each position's pool
// slot (-1: outside [lo, hi] or unset) to shared memory; then every thread
// gathers K and V rows with 16-byte cp.async copies into the swizzled
// layout wgmma reads, a slot of -1 filling zeros without a read.  Two
// stages: tile i+1's copies are in flight while tile i is multiplied.
// cp.async over TMA: a 64-position tile spans 4 pages of 16 rows at a
// stride of K*D*2 bytes, so TMA would take 4 page boxes per panel and
// tensor (16 issues a tile) and could not skip unset pages or clamp page
// ids by itself; a per-row gather does all of it with no tensor map.  A
// row that sees no position gets the mean of V over every table entry
// (mean_of_v), as below.
//
// paged_decode_kernel (decode and verify; float32): CUDA cores, fp32 (tensor
// cores in TF32 cannot hold the 2e-5 float32 tolerance).  One block per
// (tile of at most 32 query rows, KV head, batch row).  The rows of a tile
// share one KV head (GQA), so each K/V position is read once for all of
// them; tiling the rows over the grid keeps the fp32 query and accumulator
// tiles in shared memory at any T.  A block walks only the positions its
// rows can see, from its first row's window start (0 without a window) to
// its last row's q_pos, in tiles of 64 positions.  Each position's page
// id comes from the block table with a plain load; unset pages are not read
// at all.  K/V are staged in shared memory as fp32 (K rows padded to D+1
// floats, free of bank conflicts) with an fp32 online softmax, as in
// decode_attention.cu.  Shared memory follows from the tile's row count at
// launch and opts in above 48 KB.  Next step: split-KV for the decode
// shapes (64 blocks for 132 SMs).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): admission B=8 T=1024 over 1024
// positions 0.1828 ms, 5.3x its bound, against 5.2586 ms for the CUDA-core
// kernel it replaces and 0.2725 ms for a gather plus SDPA (one warpgroup a
// block: ~10% slower, attention_variants.py).  What still holds it
// back: no producer/consumer warp specialisation (every thread both gathers
// and multiplies, with a block barrier every tile, and S = QK^T waits for
// the previous tile's softmax and PV), no persistent grid, causal diagonal
// tiles multiplied whole, and every query tile of a head re-reading its
// pages from position 0 (from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;        // positions per tile
constexpr int ROWS = 32;      // query rows per block, at most
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The output of a row that sees no position: the plain version's softmax
// over P*ps masked slots is uniform, so it is the mean of V over every table
// entry, an unset entry read as page 0.  Written to out[0, D) by the block.
template <int D, typename T>
__device__ void mean_of_v(float* out, const T* __restrict__ vp, const int* __restrict__ btb,
                          int kh, int K, int n_pages, int ps, int P, int threads) {
  const size_t slot_stride = (size_t)K * D;
  for (int d = threadIdx.x; d < D; d += threads) {
    float sum = 0.f, page0 = 0.f;
    int n_unset = 0;
    for (int i = 0; i < P; ++i) {
      const int page = min(btb[i], n_pages - 1);
      if (page < 0) {
        ++n_unset;
        continue;
      }
      for (int s = 0; s < ps; ++s)
        sum += to_f(vp[((size_t)page * ps + s) * slot_stride + (size_t)kh * D + d]);
    }
    for (int s = 0; n_unset && s < ps; ++s)
      page0 += to_f(vp[(size_t)s * slot_stride + (size_t)kh * D + d]);
    out[d] = (sum + n_unset * page0) / (float)(P * ps);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ cache_len, const int* __restrict__ bt,
    T* __restrict__ out, int n_tok, int H, int K, int n_pages, int ps, int P,
    int rows, int window, float scale) {
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K, TG = n_tok * G;
  const int r0 = blockIdx.x * rows, nr = min(rows, TG - r0);
  extern __shared__ float smem[];
  float* sq = smem;                      // rows x D      scaled queries
  float* sacc = sq + rows * D;           // rows x D      output accumulator
  float* sk = sacc + rows * D;           // BK x (D+1)    K tile
  float* sv = sk + BK * (D + 1);         // BK x D        V tile
  float* ss = sv + BK * D;               // rows x BK     scores, then p
  float* sm = ss + rows * BK;            // rows          running max
  float* sl = sm + rows;                 // rows          running sum
  float* scorr = sl + rows;              // rows          this tile's rescale
  int* sslot = reinterpret_cast<int*>(scorr + rows);  // BK: pool slot, -1 unread
  int* sflag = sslot + BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* btb = bt + (size_t)b * P;
  const size_t slot_stride = (size_t)K * D;  // one page slot: K heads x D
  const int q0 = cache_len[b] - n_tok;       // position of token 0
  // the positions some row of this tile can see lie in [lo, hi]
  const int hi = min(q0 + (r0 + nr - 1) / G, P * ps - 1);
  const int lo = window < 0 ? 0 : max(0, q0 + r0 / G - window + 1);

  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = r0 + i / D, d = i % D, t = r / G, g = r % G;
    sq[i] = to_f(q[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d]) * scale;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += THREADS) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }

  for (int s0 = lo / BK * BK; s0 <= hi; s0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int j = tid; j < BK; j += THREADS) {
      const int p = s0 + j;
      int page = p >= lo && p <= hi ? btb[p / ps] : -1;
      page = min(page, n_pages - 1);  // as the plain version's clamp
      sslot[j] = page >= 0 ? page * ps + p % ps : -1;
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D, slot = sslot[j];
      const size_t at = (size_t)slot * slot_stride + (size_t)kh * D + d;
      sk[j * (D + 1) + d] = slot >= 0 ? to_f(kp[at]) : 0.f;
      sv[j * D + d] = slot >= 0 ? to_f(vp[at]) : 0.f;
    }
    __syncthreads();

    // scores: a warp covers 32 positions of one row (q broadcast, K conflict-free)
    for (int i = tid; i < nr * BK; i += THREADS) {
      const int r = i / BK, j = i % BK;
      const float* qr = sq + r * D;
      const float* kj = sk + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kj[d];
      const int p = s0 + j, q_pos = q0 + (r0 + r) / G;
      const bool ok = sslot[j] >= 0 && p <= q_pos && (window < 0 || p > q_pos - window);
      ss[i] = ok ? dot : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < nr; r += THREADS / 32) {
      float* sr = ss + r * BK;
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[r], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        scorr[r] = c;
        sl[r] = sl[r] * c + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: consecutive threads take consecutive d
    for (int i = tid; i < nr * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * BK;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < BK; ++j) a += pr[j] * sv[j * D + d];
      sacc[i] = sacc[i] * scorr[r] + a;
    }
  }
  __syncthreads();

  // a row that saw no position keeps m = -1e30: the plain version's softmax
  // over P*ps masked slots is uniform, so its output is the mean of V over
  // every table entry, an unset entry read as page 0 (computed only if needed)
  if (tid == 0) {
    int any = 0;
    for (int r = 0; r < nr; ++r) any |= sm[r] == NEG_INF;
    *sflag = any;
  }
  __syncthreads();
  if (*sflag) {
    mean_of_v<D>(sv, vp, btb, kh, K, n_pages, ps, P, THREADS);
    __syncthreads();
  }
  for (int i = tid; i < nr * D; i += THREADS) {
    const int rl = i / D, r = r0 + rl, d = i % D, t = r / G, g = r % G;
    store(out + (((size_t)b * n_tok + t) * H + kh * G + g) * D + d,
          sm[rl] == NEG_INF ? sv[d] : sacc[i] / fmaxf(sl[rl], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* cache_len,
           const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages,
           int ps, int P, int window, float scale, cudaStream_t stream) {
  const int TG = n_tok * (H / K), rows = TG < ROWS ? TG : ROWS;
  const size_t smem = sizeof(float) * (2 * rows * D + BK * (D + 1) + BK * D + rows * BK
                                       + 3 * rows) + sizeof(int) * (BK + 1);
  auto kern = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((TG + rows - 1) / rows, K, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      cache_len, bt, static_cast<T*>(out), n_tok, H, K, n_pages, ps, P, rows, window,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 admission, wgmma

constexpr int PREFILL_MIN_ROWS = 32;  // T*G at or above which bf16 takes paged_prefill_kernel
constexpr int WGS = 2;                // consumer warpgroups (64 query rows each) per block

template <int D>
constexpr size_t prefill_smem() {  // Q tiles, 2 stages of K and V, 3 slot rows, mean of V
  return 1024 + (size_t)(WGS + 4) * tile::tile_bytes(D) + 3 * tile::BK * 4 + D * 4;
}

template <int D>
__global__ void __launch_bounds__(128 * WGS) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ cache_len,
    const int* __restrict__ bt, __nv_bfloat16* __restrict__ out, int n_tok, int H, int K,
    int n_pages, int ps, int P, int window, float scale_log2) {
  using tile::BQ;
  using tile::Tile;
  constexpr int ROWS = BQ * WGS, TB = tile::tile_bytes(D), NT = 128 * WGS, CH = D / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tile::smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, skv = base + WGS * TB;
  int* sslot = reinterpret_cast<int*>(smem_raw + (base - raw) + (WGS + 4) * TB);  // [3][BK]
  float* smean = reinterpret_cast<float*>(sslot + 3 * BK);                         // [D]
  const int tid = threadIdx.x, wg = tid / 128;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K, TG = n_tok * G;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * ROWS;  // heaviest causal tiles first
  const int nr = min(ROWS, TG - r0);
  const int* btb = bt + (size_t)b * P;
  const size_t slot_stride = (size_t)K * D;  // one page slot: K heads x D
  const int q0 = cache_len[b] - n_tok;       // position of token 0
  // the positions some row of this tile can see lie in [lo, hi]
  const int hi = min(q0 + (r0 + nr - 1) / G, P * ps - 1);
  const int lo = window < 0 ? 0 : max(0, q0 + r0 / G - window + 1);
  const int s_begin = lo / BK * BK;
  const int n = hi >= s_begin ? (hi - s_begin) / BK + 1 : 0;

  auto slots = [&](int i) {  // threads < BK: tile i's pool slots (-1: not read), from the table
    const int p = s_begin + i * BK + tid;
    int page = p >= lo && p <= hi ? btb[p / ps] : -1;
    page = min(page, n_pages - 1);  // as the plain version's clamp
    sslot[(i % 3) * BK + tid] = page >= 0 ? page * ps + p % ps : -1;
  };
  auto load = [&](int i) {  // every thread: tile i's K and V rows into stage i % 2
    const int* sl = sslot + (i % 3) * BK;
    const uint32_t st = skv + (i & 1) * 2 * TB;
    for (int e = tid; e < BK * CH; e += NT) {
      const int j = e / CH, c = e % CH * 8, slot = sl[j];
      const size_t at = (size_t)max(slot, 0) * slot_stride + (size_t)kh * D + c;
      const uint32_t off = tile::tile_offset<D>(j, c);
      tile::cp_async16(st + off, kp + at, slot >= 0 ? 16 : 0);  // unread rows are zeros
      tile::cp_async16(st + TB + off, vp + at, slot >= 0 ? 16 : 0);
    }
    tile::cp_async_commit();
  };

  if (tid < BK) {
    if (n > 0) slots(0);
    if (n > 1) slots(1);
  }
  for (int i = tid; i < ROWS * CH; i += NT) {  // query row r = t*G + g of KV head kh
    const int r = r0 + i / CH, c = i % CH * 8, rr = min(r, TG - 1);
    tile::cp_async16(sq + (i / CH / BQ) * TB + tile::tile_offset<D>(i / CH % BQ, c),
                     q + (((size_t)b * n_tok + rr / G) * H + kh * G + rr % G) * D + c,
                     r < TG ? 16 : 0);
  }
  tile::cp_async_commit();
  __syncthreads();  // slot rows of tiles 0 and 1 written
  if (n > 0) load(0);

  Tile<D> t;
  t.init();
  int qp[2];  // the query positions of this thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q0 + (r0 + wg * BQ + Tile<D>::row(h)) / G;
  for (int i = 0; i < n; ++i) {
    tile::cp_async_wait_all();  // tile i (and the q tile) landed
    tile::fence_async_smem();
    __syncthreads();            // ... for every thread; tile i-1 consumed
    if (i + 1 < n) load(i + 1);
    if (i + 2 < n && tid < BK) slots(i + 2);
    const int s0 = s_begin + i * BK;
    const int* sl = sslot + (i % 3) * BK;
    const uint32_t st = skv + (i & 1) * 2 * TB;
    t.step(sq + wg * TB, st, st + TB, scale_log2, [&](int h, int, int c, float x) {
      const int p = s0 + c;
      const bool ok = sl[c] >= 0 && p <= qp[h] && (window < 0 || p > qp[h] - window);
      return ok ? x : NEG_INF;
    });
  }
  tile::cp_async_wait_all();

  bool none = false;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    none |= r0 + wg * BQ + Tile<D>::row(h) < TG && t.m[h] == NEG_INF;
  if (__syncthreads_or(none)) {
    mean_of_v<D>(smean, vp, btb, kh, K, n_pages, ps, P, NT);
    __syncthreads();
  }
  t.finish([&](int h, int r, int c, float x0, float x1) {
    const int rr = r0 + wg * BQ + r;
    if (rr >= TG) return;
    if (t.m[h] == NEG_INF) {
      x0 = smean[c];
      x1 = smean[c + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * n_tok + rr / G) * H + kh * G + rr % G) * D + c) =
        __floats2bfloat162_rn(x0, x1);
  });
}

template <int D>
int launch_prefill(const void* q, const void* kp, const void* vp, const int* cache_len,
                   const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages,
                   int ps, int P, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem<D>();
  auto kern = paged_prefill_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = tile::BQ * WGS, TG = n_tok * (H / K);
  kern<<<dim3(K, B, (TG + rows - 1) / rows), 128 * WGS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), cache_len, bt, static_cast<__nv_bfloat16*>(out),
      n_tok, H, K, n_pages, ps, P, window, scale * tile::LOG2E);
  return (int)cudaGetLastError();
}

#define PAGED_ARGS q, kp, vp, cl, bt, out, B, n_tok, H, K, n_pages, ps, P, window, scale, st

int route(int n_tok, int H, int K, int dtype) {
  return dtype == 1 && n_tok * (H / K) >= PREFILL_MIN_ROWS ? 1 : 0;
}

int dispatch(int D, int dtype, const void* q, const void* kp, const void* vp, const int* cl,
             const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages, int ps,
             int P, int window, float scale, cudaStream_t st) {
  if (route(n_tok, H, K, dtype)) switch (D) {
      case 32: return launch_prefill<32>(PAGED_ARGS);
      case 64: return launch_prefill<64>(PAGED_ARGS);
      case 128: return launch_prefill<128>(PAGED_ARGS);
    }
  if (dtype == 0) switch (D) {
      case 32: return launch<float, 32>(PAGED_ARGS);
      case 64: return launch<float, 64>(PAGED_ARGS);
      case 128: return launch<float, 128>(PAGED_ARGS);
    }
  if (dtype == 1) switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(PAGED_ARGS);
      case 64: return launch<__nv_bfloat16, 64>(PAGED_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(PAGED_ARGS);
    }
  return (int)cudaErrorInvalidValue;
}

#undef PAGED_ARGS

}  // namespace

// Which kernel a call takes: 1 = paged_prefill_kernel (bf16 with T*G at or
// above PREFILL_MIN_ROWS: admission), 0 = paged_decode_kernel.  Shape and
// dtype only.
extern "C" int decode_attention_paged_route(int n_tok, int H, int K, int dtype) {
  return route(n_tok, H, K, dtype);
}

// q (B, T, H, D); k_pages, v_pages (n_pages, ps, K, D); cache_len (B,) int32
// (the T new tokens included); block_tables (B, P) int32, -1 = unset;
// out (B, T, H, D).  All contiguous.  dtype: 0 = float32, 1 = bfloat16.
// window < 0 means no sliding window.  Returns cudaGetLastError() after the
// launch, or the error that refused it.
extern "C" int decode_attention_paged(const void* q, const void* k_pages,
                                      const void* v_pages, const int* cache_len,
                                      const int* block_tables, void* out, int B, int n_tok,
                                      int H, int K, int D, int n_pages, int ps, int P,
                                      int window, float scale, int dtype, void* stream) {
  return dispatch(D, dtype, q, k_pages, v_pages, cache_len, block_tables, out, B, n_tok, H, K,
                  n_pages, ps, P, window, scale, static_cast<cudaStream_t>(stream));
}
