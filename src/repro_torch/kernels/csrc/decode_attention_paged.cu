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
// Two kernels; the C entry point picks one by dtype
// (decode_attention_paged_route).
//
// paged_wgmma_kernel (bfloat16: every admission, decode and verify call):
// the tensor-core tile loop of attention_tile.cuh (SASS: HGMMA.64x64x16.F32.
// BF16 for S, 64x128x16 for PV; chip_smoke.py checks both).  One block per
// (KV head, batch row, tile of query rows r = t*G + g, split), heaviest
// causal tiles first: one warpgroup of 64 rows while T*G <= 64 (decode,
// verify, admissions of up to 32 tokens), else two warpgroups of 64 sharing
// each staged K/V tile (faster at admission than one).  The tile's rows see
// positions [lo, hi] (the first row's window start to the last row's q_pos,
// hi clamped to P*ps - 1).  Split-KV: where the query tiles leave SMs idle
// (decode: 64 of them for 132 SMs) each one's 64-position tiles over P*ps
// are cut into as many static ranges as put one block on every SM (2 at the
// decode shape), at most 8, and a split walks the tiles of its range that
// meet [lo, hi]; a split left with none (short rows, idle rows) is marked
// empty, and the splits are merged by the cluster combine of
// attention_tile.cuh.  Admission's query tiles fill the card: one split.
// For each tile, 64 threads read the block table once and
// write each position's pool slot (-1: outside [lo, hi] or unset) to shared
// memory; then every thread gathers K and V rows with 16-byte cp.async
// copies into the swizzled layout wgmma reads, a slot of -1 filling zeros
// without a read (walk, attention_tile.cuh).  Three stages: two tiles'
// copies in flight while one is multiplied.  cp.async over TMA: a
// 64-position tile spans 4 pages of 16 rows at a stride of K*D*2 bytes, so
// TMA would take 4 page boxes per panel and tensor and could not skip unset
// pages or clamp page ids.  A row that sees no position in any split gets
// the mean of V over every table entry (mean_of_v).  Measured by
// attention_variants.py in the same run (B=8 T=9 over 1024): 2 splits
// 0.0260 ms, no split 0.0385, 4 splits (two blocks an SM) 0.0340 with two
// stages; two stages 0.0276, four 0.0273.
//
// paged_decode_kernel (float32): CUDA cores, fp32 (tensor cores in TF32
// cannot hold the 2e-5 float32 tolerance).  One block per (tile of at most
// 32 query rows, KV head, batch row).  The rows of a tile share one KV head
// (GQA), so each K/V position is read once for all of them; tiling the rows
// over the grid keeps the fp32 query and accumulator tiles in shared memory
// at any T.  A block walks only the positions its rows can see, from its
// first row's window start (0 without a window) to its last row's q_pos, in
// tiles of 64 positions.  Each position's page id comes from the block table
// with a plain load; unset pages are not read at all.  K/V are staged in
// shared memory as fp32 (K rows padded to D+1 floats, free of bank
// conflicts) with an fp32 online softmax, as in decode_attention.cu.  Shared
// memory follows from the tile's row count at launch and opts in above 48 KB.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): decode B=8 T=9 over 1024 positions
// 0.0262 ms, 2.6x its bound, against 0.4635 ms for the CUDA-core kernel it
// replaces and 0.0654 ms for a gather plus SDPA; admission B=8 T=1024 0.1880
// ms, 5.4x its bound, against 0.2760 ms for a gather plus SDPA, and 0.1821
// ms for the admission kernel before split-KV (another run).  What still
// holds it back: at decode, one block of one warpgroup an
// SM (each tile's table read, gathers, products and barrier in series, with
// nothing on the SM to hide them; the prologue and the cluster combine paid
// per block) and a 64-row product tile for at most 18 live rows; at
// admission, no producer/consumer warp specialisation (a block barrier every
// tile, S = QK^T waiting for the previous tile's softmax and PV), no
// persistent grid, causal diagonal tiles multiplied whole, and every query
// tile of a head re-reading its pages from position 0 (from L2).
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

template <int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ kp, const float* __restrict__ vp,
    const int* __restrict__ cache_len, const int* __restrict__ bt,
    float* __restrict__ out, int n_tok, int H, int K, int n_pages, int ps, int P,
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
    sq[i] = q[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d] * scale;
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
      sk[j * (D + 1) + d] = slot >= 0 ? kp[at] : 0.f;
      sv[j * D + d] = slot >= 0 ? vp[at] : 0.f;
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
    out[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d] =
        sm[rl] == NEG_INF ? sv[d] : sacc[i] / fmaxf(sl[rl], 1e-30f);
  }
}

template <int D>
int launch(const void* q, const void* kp, const void* vp, const int* cache_len,
           const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages,
           int ps, int P, int window, float scale, cudaStream_t stream) {
  const int TG = n_tok * (H / K), rows = TG < ROWS ? TG : ROWS;
  const size_t smem = sizeof(float) * (2 * rows * D + BK * (D + 1) + BK * D + rows * BK
                                       + 3 * rows) + sizeof(int) * (BK + 1);
  auto kern = paged_decode_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((TG + rows - 1) / rows, K, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), cache_len, bt, static_cast<float*>(out), n_tok, H, K,
      n_pages, ps, P, rows, window, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------- bf16, wgmma, split-KV

template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS) paged_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ cache_len,
    const int* __restrict__ bt, __nv_bfloat16* __restrict__ out, int n_tok, int H, int K,
    int n_pages, int ps, int P, int window, float scale_log2, int n_split) {
  using tile::BQ;
  using tile::Tile;
  using L = tile::Layout<D, WGS>;
  constexpr int ROWS = BQ * WGS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = tile::aligned_smem(smem_raw);
  int* sslot = reinterpret_cast<int*>(sm + L::slot);
  float* smean = reinterpret_cast<float*>(sm + L::mean);
  const int tid = threadIdx.x, wg = tid / 128;
  const int kh = blockIdx.x / n_split, split = blockIdx.x % n_split, b = blockIdx.y;
  const int G = H / K, TG = n_tok * G;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * ROWS;  // heaviest causal tiles first
  const int nr = min(ROWS, TG - r0);
  const int* btb = bt + (size_t)b * P;
  const int q0 = cache_len[b] - n_tok;  // position of token 0
  // the positions some row of this tile can see lie in [lo, hi]; this split
  // walks the tiles of its static range that meet them
  const int hi = min(q0 + (r0 + nr - 1) / G, P * ps - 1);
  const int lo = window < 0 ? 0 : max(0, q0 + r0 / G - window + 1);
  const int n_tiles = (P * ps + BK - 1) / BK, span = tile::split_span(n_tiles, n_split);
  const int first = max(split * span, lo / BK);
  const int last = hi < lo ? -1 : min(min(n_tiles, (split + 1) * span) - 1, hi / BK);
  const int n = max(0, last - first + 1);

  tile::load_q<D, WGS>(tile::smem_u32(sm), q, b, n_tok, H, G, kh, r0);
  Tile<D> t;
  t.init();
  int qp[2];  // the query positions of this thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q0 + (r0 + wg * BQ + Tile<D>::row(h)) / G;
  tile::walk<D, WGS>(
      t, sm, n, kp, vp, (size_t)K * D, (size_t)kh * D, scale_log2,
      [&](int i, int ring) {  // pool rows from the table; -1 outside [lo, hi] or unset
        const int p = (first + i) * BK + tid;
        int page = p >= lo && p <= hi ? btb[p / ps] : -1;
        page = min(page, n_pages - 1);  // as the plain version's clamp
        sslot[ring * BK + tid] = page >= 0 ? page * ps + p % ps : -1;
      },
      [&](int i, int ring, int h, int c, float x) {
        const int p = (first + i) * BK + c;
        const bool ok = sslot[ring * BK + c] >= 0 && p <= qp[h] &&
                        (window < 0 || p > qp[h] - window);
        return ok ? x : NEG_INF;
      });
  tile::finish_rows<D, WGS>(
      t, sm, nr, n_split, n > 0,
      [&] { mean_of_v<D>(smean, vp, btb, kh, K, n_pages, ps, P, 128 * WGS); },
      [&](int r, int c, float x0, float x1, float M) {
        const int rr = r0 + r;
        if (M <= NEG_INF) {  // saw no position: the mean of V over the table
          x0 = smean[c];
          x1 = smean[c + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * n_tok + rr / G) * H + kh * G + rr % G) * D + c) =
            __floats2bfloat162_rn(x0, x1);
      });
}

template <int D, int WGS>
int launch_wgmma(const void* q, const void* kp, const void* vp, const int* cache_len,
                 const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages, int ps,
                 int P, int window, float scale, cudaStream_t stream) {
  const int TG = n_tok * (H / K), q_tiles = (TG + tile::BQ * WGS - 1) / (tile::BQ * WGS);
  const int n_split = tile::split_count(K * B * q_tiles, (P * ps + BK - 1) / BK);
  return (int)tile::launch_split<paged_wgmma_kernel<D, WGS>>(
      dim3(K * n_split, B, q_tiles), 128 * WGS, tile::Layout<D, WGS>::bytes, n_split, stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp), static_cast<const __nv_bfloat16*>(vp), cache_len,
      bt, static_cast<__nv_bfloat16*>(out), n_tok, H, K, n_pages, ps, P, window,
      scale * tile::LOG2E, n_split);
}

#define PAGED_ARGS q, kp, vp, cl, bt, out, B, n_tok, H, K, n_pages, ps, P, window, scale, st

int dispatch(int D, int dtype, const void* q, const void* kp, const void* vp, const int* cl,
             const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages, int ps,
             int P, int window, float scale, cudaStream_t st) {
  // one warpgroup where one 64-row tile holds a KV head's rows (decode,
  // verify, short admissions), two above
  const bool one = n_tok * (H / K) <= tile::BQ;
  if (dtype == 1) switch (D) {
      case 32: return one ? launch_wgmma<32, 1>(PAGED_ARGS) : launch_wgmma<32, 2>(PAGED_ARGS);
      case 64: return one ? launch_wgmma<64, 1>(PAGED_ARGS) : launch_wgmma<64, 2>(PAGED_ARGS);
      case 128: return one ? launch_wgmma<128, 1>(PAGED_ARGS) : launch_wgmma<128, 2>(PAGED_ARGS);
    }
  if (dtype == 0) switch (D) {
      case 32: return launch<32>(PAGED_ARGS);
      case 64: return launch<64>(PAGED_ARGS);
      case 128: return launch<128>(PAGED_ARGS);
    }
  return (int)cudaErrorInvalidValue;
}

#undef PAGED_ARGS

}  // namespace

// Which kernel a call takes: 1 = paged_wgmma_kernel (bfloat16), 0 =
// paged_decode_kernel (float32).
extern "C" int decode_attention_paged_route(int dtype) {
  return dtype == 1;
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
