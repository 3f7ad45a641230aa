// Flash-decode attention of T new query tokens against a dense or ring-buffer
// KV cache, for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (the TPU kernel _decode_kernel).  Same function: query row r = t*G + g of
// KV head kh sits at absolute position cache_len - T + t; cache slot j is
// visible iff 0 <= kv_pos[j] <= q_pos (and kv_pos[j] > q_pos - window when a
// window is given).  Stale speculative slots carry positions above the
// rewound cache_len and are masked, so rollback needs no cache rewrite.
// Masked scores are -1e30 (not -inf): a fully masked row averages V over all
// S slots and stays finite, like the plain version.
//
// Bound on this card: bytes.  Each launch must read the K and V cache once
// (main path, B=8 T=5 S=512, 8 KV heads of 128, bf16: 2 * 8 * 512 * 8 * 128
// * 2 B = 16.8 MB), 5.0 us at 3.35 TB/s, against ~0.2 GFLOP of products.
//
// Two kernels; the C entry point picks one by dtype (decode_attention_route).
//
// decode_wgmma_kernel (bfloat16, every serve): the tensor-core tile loop of
// attention_tile.cuh with split-KV.  A block holds the T*G query rows of one
// KV head (one warpgroup of 64 rows while T*G <= 64, two above) and walks a
// static share of the S slots in tiles of 64: as many splits as put one
// block on every SM (2 on the main path: 128 blocks), at most 8 and one a
// tile; the splits of a query tile are one cluster, merged through
// distributed shared memory (the combine in attention_tile.cuh).  A ring's
// slot order is not position order, so each split walks every slot of its
// range and masks by the tile's positions; a fully masked row scores -1e30
// in every split, and the combine's equal weights (over each split's slot
// count) give the mean of V over all S.  K and V tiles (64 consecutive slots
// of the (B, S, K*D) cache, one swizzle panel a box, slots past S arriving as
// zeros and scored -inf) come by TMA, one thread issuing them against an
// mbarrier per stage; each tile's 64 positions by 4-byte cp.async (a
// tensor map would need a 16-byte row stride, S a multiple of 4; the
// serving path may give any S); three stages, two tiles in flight while one
// is multiplied.  TMA for K/V was measured faster than K3's 16-byte
// cp.async row gathers on the same tiles.
//
// decode_kernel (float32): CUDA cores (tensor cores in TF32 cannot hold the
// 2e-5 float32 tolerance).  One block per (kv head, batch row, tile of up to
// QT = 64 of the T*G query rows that share the KV head), so GQA's rows read
// each K/V tile once a tile of rows.  The block walks the cache in tiles of 64
// slots staged in shared memory (as fp32; K rows padded to D+1 floats so the
// score loop is free of bank conflicts), keeps an fp32 online softmax per row
// in shared memory, and writes fp32.  Shared memory is sized from the row
// tile (148,736 B at D = 128), not from T*G, so any chunked-prefill T
// launches (T*G = 128 alone took 231,424 B, near the 232,448 B opt-in
// ceiling, and 256 rows were refused); it opts in above 48 KB.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): B=8 T=5 S=512 bf16 0.0151 ms, 3.0x its
// bound, against 0.1722 ms for the CUDA-core kernel it replaces and 0.0277 ms
// for scaled_dot_product_attention; attention_variants.py in the same run:
// 2 splits 0.0150 ms, no split 0.0187, 4 splits (two blocks an SM) 0.0198
// with two stages; two stages 0.0143, four 0.0161 (STAGES is shared with
// K3, which is larger and fastest at three).  What still holds it back: one
// block of one warpgroup an SM, so each tile's wait, products, softmax and
// barrier run in series with nothing on the SM to hide them (two blocks an
// SM, or more splits, were slower: the cluster combine and the prologue are
// paid per block); the 64-row product tile holds at most 18 live rows here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;        // cache slots per tile
constexpr int QT = 64;        // query rows a float32 block
constexpr int THREADS = 256;

// ----------------------------------------------------- float32, CUDA cores

template <int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ cache_len, const int* __restrict__ kv_pos,
    float* __restrict__ out, int n_tok, int H, int K, int S, int window, float scale) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K, r0 = blockIdx.z * QT, nr = min(QT, n_tok * G - r0);
  extern __shared__ float smem[];
  float* sq = smem;                      // nr x D      scaled queries
  float* sacc = sq + nr * D;             // nr x D      output accumulator
  float* sk = sacc + nr * D;             // BK x (D+1)  K tile
  float* sv = sk + BK * (D + 1);         // BK x D      V tile
  float* ss = sv + BK * D;               // nr x BK     scores, then p
  float* sm = ss + nr * BK;              // nr          running max
  float* sl = sm + nr;                   // nr          running sum
  float* scorr = sl + nr;                // nr          this tile's rescale
  int* spos = reinterpret_cast<int*>(scorr + nr);  // BK slot positions
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int clen = cache_len[b];
  const size_t slot_stride = (size_t)K * D;
  const float* kb = k + (size_t)b * S * slot_stride + (size_t)kh * D;
  const float* vb = v + (size_t)b * S * slot_stride + (size_t)kh * D;

  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = r0 + i / D, d = i % D, t = r / G, g = r % G;
    sq[i] = q[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d] * scale;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += THREADS) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const bool in = s0 + j < S;
      sk[j * (D + 1) + d] = in ? kb[(size_t)(s0 + j) * slot_stride + d] : 0.f;
      sv[j * D + d] = in ? vb[(size_t)(s0 + j) * slot_stride + d] : 0.f;
    }
    for (int j = tid; j < BK; j += THREADS)
      spos[j] = s0 + j < S ? kv_pos[(size_t)b * S + s0 + j] : -1;
    __syncthreads();

    // scores: a warp covers 32 slots of one row (q broadcast, K conflict-free)
    for (int i = tid; i < nr * BK; i += THREADS) {
      const int r = i / BK, j = i % BK;
      const float* qr = sq + r * D;
      const float* kj = sk + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kj[d];
      const int p = spos[j], q_pos = clen - n_tok + (r0 + r) / G;
      const bool ok = p >= 0 && p <= q_pos && (window < 0 || p > q_pos - window);
      // slots past S do not exist at all (-inf); masked slots are -1e30
      ss[i] = s0 + j >= S ? -INFINITY : (ok ? dot : NEG_INF);
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
  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = i / D, d = i % D, t = (r0 + r) / G, g = (r0 + r) % G;
    out[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d] = sacc[i] / fmaxf(sl[r], 1e-30f);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           const int* kv_pos, void* out, int B, int n_tok, int H, int K, int S,
           int window, float scale, cudaStream_t stream) {
  const int TG = n_tok * (H / K), QR = TG < QT ? TG : QT;  // rows of the largest tile
  const size_t smem = sizeof(float) * (2 * QR * D + BK * (D + 1) + BK * D + QR * BK + 3 * QR)
                      + sizeof(int) * BK;
  auto kern = decode_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(K, B, (TG + QT - 1) / QT), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      cache_len, kv_pos, static_cast<float*>(out), n_tok, H, K, S, window, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------- bf16, wgmma, split-KV

template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS) decode_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ cache_len,
    const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out, int n_tok, int H, int K,
    int S, int window, float scale_log2, int n_split) {
  using namespace tile;
  using L = Layout<D, WGS>;
  constexpr int TB = tile_bytes(D), SW = swizzle_bytes(D), PW = SW / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t sq = smem_u32(sm), skv = sq + L::kv, bars = sq + L::bar;
  int* spos = reinterpret_cast<int*>(sm + L::pos);  // [STAGES][BK]
  const int tid = threadIdx.x, wg = tid / 128;
  const int kh = blockIdx.x / n_split, split = blockIdx.x % n_split, b = blockIdx.y;
  const int G = H / K, TG = n_tok * G;
  const int r0 = blockIdx.z * BQ * WGS, nr = min(BQ * WGS, TG - r0);
  const int q0 = cache_len[b] - n_tok;  // position of token 0
  // a ring's slot order is not position order: a split walks every slot of
  // its static range of the S slots
  const int n_tiles = (S + BK - 1) / BK, span = split_span(n_tiles, n_split);
  const int first = split * span, n = max(0, min(n_tiles - first, span));
  const int* posb = kv_pos + (size_t)b * S;
  // tile i into stage i % STAGES: K and V by TMA on the stage's mbarrier (one
  // thread), the 64 positions by 4-byte cp.async (threads < BK; any row
  // stride, so any S), one copy group a tile on every thread
  auto issue = [&](int i) {
    const int st = i % STAGES, s0 = (first + i) * BK;
    if (tid == 0) {
      const uint32_t dst = skv + st * 2 * TB, bar = bars + st * 8;
      mbar_expect_tx(bar, 2 * TB);
#pragma unroll
      for (int p = 0; p < D / PW; ++p) {
        tma_load_3d(dst + p * BK * SW, &kmap, bar, kh * D + p * PW, s0, b);
        tma_load_3d(dst + TB + p * BK * SW, &vmap, bar, kh * D + p * PW, s0, b);
      }
    }
    if (tid < BK && s0 + tid < S) cp_async4(smem_u32(spos + st * BK + tid), posb + s0 + tid);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = 0; i < STAGES - 1 && i < n; ++i) issue(i);
  load_q<D, WGS>(sq, q, b, n_tok, H, G, kh, r0);  // commits the first positions too
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();  // Q and the first tiles' positions staged, barriers initialised

  Tile<D> t;
  t.init();
  int qp[2];  // the query positions of this thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q0 + (r0 + wg * BQ + Tile<D>::row(h)) / G;
  for (int i = 0; i < n; ++i) {
    if (i > 0) {
      cp_async_wait<STAGES - 2>();  // tile i's positions landed
      __syncthreads();  // ... for every thread; tile i - 1 consumed: its stage takes tile i + STAGES - 1
    }
    if (i + STAGES - 1 < n) issue(i + STAGES - 1);
    cp_async_commit();
    const int st = i % STAGES, s0 = (first + i) * BK;
    mbar_wait(bars + st * 8, (i / STAGES) & 1);
    const uint32_t kv = skv + st * 2 * TB;
    t.step(sq + wg * TB, kv, kv + TB, scale_log2, [&](int h, int, int c, float x) {
      if (s0 + c >= S) return -INFINITY;  // slots past S do not exist
      const int p = spos[st * BK + c];
      const bool ok = p >= 0 && p <= qp[h] && (window < 0 || p > qp[h] - window);
      return ok ? x : NEG_INF;
    });
  }
  finish_rows<D, WGS>(t, sm, nr, n_split, n > 0, [] {},
                      [&](int r, int c, float x0, float x1, float) {
                        const int rr = r0 + r;
                        *reinterpret_cast<__nv_bfloat162*>(
                            out + (((size_t)b * n_tok + rr / G) * H + kh * G + rr % G) * D + c) =
                            __floats2bfloat162_rn(x0, x1);
                      });
}

template <int D, int WGS>
int launch_wgmma(const void* q, const void* k, const void* v, const int* cache_len,
                 const int* kv_pos, void* out, int B, int n_tok, int H, int K, int S,
                 int window, float scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!tile::kv_map<D>(&kmap, k, B, S, K) || !tile::kv_map<D>(&vmap, v, B, S, K))
    return (int)cudaErrorInvalidValue;
  const int TG = n_tok * (H / K), q_tiles = (TG + tile::BQ * WGS - 1) / (tile::BQ * WGS);
  const int n_split = tile::split_count(K * B * q_tiles, (S + BK - 1) / BK);
  return (int)tile::launch_split<decode_wgmma_kernel<D, WGS>>(
      dim3(K * n_split, B, q_tiles), 128 * WGS, tile::Layout<D, WGS>::bytes, n_split, stream,
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), cache_len, kv_pos,
      static_cast<__nv_bfloat16*>(out), n_tok, H, K, S, window, scale * tile::LOG2E, n_split);
}

#define DECODE_ARGS q, k, v, cl, pos, out, B, n_tok, H, K, S, window, scale, st

int dispatch(int D, int dtype, const void* q, const void* k, const void* v, const int* cl,
             const int* pos, void* out, int B, int n_tok, int H, int K, int S, int window,
             float scale, cudaStream_t st) {
  // one warpgroup where one 64-row tile holds a KV head's rows, two above
  const bool one = n_tok * (H / K) <= tile::BQ;
  if (dtype == 1) switch (D) {
      case 32: return one ? launch_wgmma<32, 1>(DECODE_ARGS) : launch_wgmma<32, 2>(DECODE_ARGS);
      case 64: return one ? launch_wgmma<64, 1>(DECODE_ARGS) : launch_wgmma<64, 2>(DECODE_ARGS);
      case 128:
        return one ? launch_wgmma<128, 1>(DECODE_ARGS) : launch_wgmma<128, 2>(DECODE_ARGS);
    }
  if (dtype == 0) switch (D) {
      case 32: return launch<32>(DECODE_ARGS);
      case 64: return launch<64>(DECODE_ARGS);
      case 128: return launch<128>(DECODE_ARGS);
    }
  return (int)cudaErrorInvalidValue;
}

#undef DECODE_ARGS

}  // namespace

// Which kernel a call takes: 1 = decode_wgmma_kernel (bfloat16), 0 =
// decode_kernel (float32).
extern "C" int decode_attention_route(int dtype) { return dtype == 1; }

// q (B, T, H, D); k, v (B, S, K, D); cache_len (B,) int32; kv_pos (B, S) int32;
// out (B, T, H, D).  All contiguous.  dtype: 0 = float32, 1 = bfloat16.
// window < 0 means no sliding window.  Returns cudaGetLastError() after the
// launch, or the error that refused it.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* cache_len, const int* kv_pos, void* out,
                                int B, int n_tok, int H, int K, int D, int S,
                                int window, float scale, int dtype, void* stream) {
  return dispatch(D, dtype, q, k, v, cache_len, kv_pos, out, B, n_tok, H, K, S, window, scale,
                  static_cast<cudaStream_t>(stream));
}
