// Flash attention backward (training) for NVIDIA Hopper (sm_90a).
//
// Replaces: what JAX differentiates on the TPU when training runs
// src/repro/kernels/flash_attention.py::flash_attention_pallas under
// jax.value_and_grad (src/repro/training/train_loop.py).  The reference has
// no custom_vjp; this kernel is the port's gradient of K2
// (flash_attention.cu), with its masking: causal, an optional sliding
// window, GQA through kv head h / G, keys past Sk absent.  q_offset 0:
// training never sets another.  Queries and keys have lengths of their own
// (Sq, Sk) without a mask: an encoder-decoder's cross attention over its
// whole memory (Sq target tokens, Sk frames); causal or windowed calls are
// self-attention, Sq = Sk.
//
// FlashAttention-2's two passes, no atomics, so the result is the same bits
// on every run (launch.train's deterministic mode and its restart check
// rely on it):
//   delta_kernel       D[b, h, i] = rowsum(dO * O)            (B*Sq*H warps)
//   dK/dV pass         one block per (b, kv head, 64-key tile): K and V stay
//                      in shared memory while it walks the query tiles that
//                      can see them, for each of the G query heads of that
//                      KV head, recomputing P = exp(S - lse) from the
//                      forward's lse, dP = dO V^T and dS = P * (dP - D), and
//                      accumulating dV += P^T dO and dK += dS^T Q;
//   dQ pass            one block per (b, query head, 64-row query tile): Q
//                      and dO stay in shared memory while it walks the
//                      visible KV tiles, accumulating dQ += dS K.
// Tiles walk the ranges a mask leaves (causal: keys up to the query tile's
// last row; window: from its first visible tile), heaviest causal tiles
// first.
//
// Bound on this card: operations.  The training shape (B=4 S=2048 H=16 K=8
// D=128, causal) needs five 64-row products over the causal half, ~172
// GFLOP: ~0.17 ms at 989 TFLOP/s bf16 (from the shapes).  The two passes do
// seven (S and dP are recomputed in the dQ pass), ~0.25 ms at that rate.
//
// bf16: dkdv_wgmma_kernel and dq_wgmma_kernel, on the tensor cores (wgmma,
// attention_tile.cuh's helpers and tile layout), one consumer warpgroup of
// 128 threads a block, every product bf16 x bf16 into fp32 registers:
//   dK/dV pass, in transposed form so that each product fits the helpers:
//     S^T  = K Q^T    m64n64k16, K and Q from shared memory, both K-major;
//     dP^T = V dO^T   m64n64k16, the same way;
//     P^T  = exp2(S^T scale log2e - lse[col] log2e), 0 where masked, and
//     dS^T = P^T * (dP^T - delta[col]) in registers (the tile's query rows
//            are its columns: lse and delta come from shared memory by
//            column), both converted to bf16 A fragments as Tile::step
//            converts P;
//     dV  += P^T dO   m64nDk16, dO the MN-major B operand (as V in the
//                     forward);
//     dK  += dS^T Q   m64nDk16, Q the MN-major B operand.
//   K and V arrive once by TMA; the Q and dO tiles of the G query heads
//   stream through two TMA stages (4-D maps over (B, S, H, D), the K/V
//   helper's), an mbarrier each, with the tile's 64 lse and delta beside
//   them by cp.async: tile i+1 is in flight while tile i is multiplied.
//   dK and dV stay in fp32 registers over the whole walk (D/2 + D/2 a
//   thread); dK is scaled once and both are stored as bf16.
//   dQ pass: S = Q K^T and dP = dO V^T (m64n64k16), P and dS as above by
//   row, dQ += dS K (m64nDk16, K the MN-major B operand); Q and dO staged
//   once by TMA, K and V streamed through two TMA stages.
//   Query rows past Sq and keys past Sk arrive as TMA zeros (each tensor
//   map has its own row count) and are masked; the lse and delta of rows
//   past Sq are read clamped to row Sq - 1; no row past its length is
//   written.
// What still holds it back: no producer/consumer warp specialisation (a
// block barrier every tile, and each tile's products wait for its
// elementwise work), no persistent grid, the two recomputed products of
// the dQ pass, and the diagonal tiles multiplied whole.
//
// float32: dkdv_kernel and dq_kernel on the CUDA cores (tensor cores in
// TF32 cannot hold the 1e-4 float32 tolerance).  Every tile is staged in
// shared memory as float32 (rows padded to D+1 floats); products run with
// float32 accumulation.  256 threads a block: the 64 x 64 score tile is
// 4 x 4 a thread, the 64 x D accumulators 8 x D/32.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, B=4 S=2048 H=16 K=8 D=128 causal bf16): 0.5115 ms, 2.9x its bound,
// against 11.7989 ms for the CUDA-core passes it replaces and 0.5054 ms for
// scaled_dot_product_attention's backward.  ptxas at D = 128: 218
// registers (dK/dV) and 155 (dQ) a thread, no spills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]; warp w is row w
// of the (B, Sq, H) layout.
template <class T>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, int Sq, int H, int D, int rows) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= rows) return;  // whole warps
  const T* o = out + (size_t)w * D;
  const T* g = dout + (size_t)w * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(o[d]) * to_f(g[d]);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = w % H, i = (w / H) % Sq, b = w / (H * Sq);
    delta[((size_t)b * H + h) * Sq + i] = s;
  }
}

// Rows r0 .. r0+63 of head n of a (B, S, N, D) tensor into dst (64 x (D+1)
// floats); rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int b,
                                          int r0, int S, int N, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < S ? src[(((size_t)b * S + r0 + r) * N + n) * D + d] : 0.f;
  }
}

// lse (scaled by log2 e) and delta of query rows q0 .. q0+63 of (b, h).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int b, int h, int q0,
                                          int Sq, int H) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const size_t i = ((size_t)b * H + h) * Sq + min(q0 + r, Sq - 1);
    s_lse[r] = lse[i] * LOG2E;
    s_delta[r] = delta[i];
  }
}

// Is position (query qp, key kp) visible?  (Queries past Sq and keys past Sk
// are not.)
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal,
                                        int window) {
  return qp < Sq && kp < Sk && !(causal && kp > qp) && !(window >= 0 && kp <= qp - window);
}

// One 64 x 64 tile of (query rows q0.., key rows k0..): recompute S = Q K^T
// and dP = dO V^T (thread (tr, tc) owns rows tr*4+i, columns tc+16c), then
// P = exp(S - lse), zero where masked, and dS = P * (dP - delta).  Writes dS
// to s_ds and, if s_p is not null, P to s_p (both 64 x 65).
template <int D>
__device__ __forceinline__ void scores(const float* sq, const float* sdo, const float* sk,
                                       const float* sv, const float* s_lse,
                                       const float* s_delta, float* s_p, float* s_ds, int q0,
                                       int k0, int Sq, int Sk, int causal, int window,
                                       float scale_log2) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sq[(tr * 4 + i) * (D + 1) + d];
      g[i] = sdo[(tr * 4 + i) * (D + 1) + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kk[c] = sk[(tc + 16 * c) * (D + 1) + d];
      vv[c] = sv[(tc + 16 * c) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] += a[i] * kk[c];
        dp[i][c] += g[i] * vv[c];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i, qp = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tc + 16 * c;
      const float p =
          visible(qp, k0 + j, Sq, Sk, causal, window) ? exp2f(s[i][c] * scale_log2 - s_lse[r])
                                                       : 0.f;
      if (s_p != nullptr) s_p[r * (BK + 1) + j] = p;
      s_ds[r * (BK + 1) + j] = p * (dp[i][c] - s_delta[r]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Sk, int H, int K, int causal, int window, float scale, float scale_log2) {
  constexpr int DC = D / 32;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + 64 * (D + 1);
  float* sq = sv + 64 * (D + 1);
  float* sdo = sq + 64 * (D + 1);
  float* s_p = sdo + 64 * (D + 1);
  float* s_ds = s_p + BQ * (BK + 1);
  float* s_lse = s_ds + BQ * (BK + 1);
  float* s_delta = s_lse + BQ;
  const int b = blockIdx.x / K, kh = blockIdx.x % K, G = H / K;
  const int k0 = blockIdx.y * BK;  // the causally heaviest tiles come first
  const int kr = threadIdx.x / 32, dc = threadIdx.x % 32;  // rows kr*8+i, cols dc+32c

  // query rows that can see any of these keys
  const int q_begin = causal ? k0 : 0;
  const int q_end = window >= 0 ? min(Sq, k0 + BK - 1 + window) : Sq;

  load_tile<D>(sk, k, b, k0, Sk, K, kh);
  load_tile<D>(sv, v, b, k0, Sk, K, kh);
  float acc_k[8][DC], acc_v[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = q_begin / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile consumed (K and V staged)
      load_tile<D>(sq, q, b, q0, Sq, H, h);
      load_tile<D>(sdo, dout, b, q0, Sq, H, h);
      load_rows(s_lse, s_delta, lse, delta, b, h, q0, Sq, H);
      __syncthreads();
      scores<D>(sq, sdo, sk, sv, s_lse, s_delta, s_p, s_ds, q0, k0, Sq, Sk, causal, window,
                scale_log2);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float p[8], ds[8], go[DC], a[DC];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          p[i] = s_p[r * (BK + 1) + kr * 8 + i];
          ds[i] = s_ds[r * (BK + 1) + kr * 8 + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          go[c] = sdo[r * (D + 1) + dc + 32 * c];
          a[c] = sq[r * (D + 1) + dc + 32 * c];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc_v[i][c] += p[i] * go[c];
            acc_k[i][c] += ds[i] * a[c];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kp = k0 + kr * 8 + i;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kp) * K + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + dc + 32 * c] = acc_k[i][c] * scale;
      dv[off + dc + 32 * c] = acc_v[i][c];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk, int H, int K,
    int causal, int window, float scale, float scale_log2) {
  constexpr int DC = D / 32;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + 64 * (D + 1);
  float* sk = sdo + 64 * (D + 1);
  float* sv = sk + 64 * (D + 1);
  float* s_ds = sv + 64 * (D + 1);
  float* s_lse = s_ds + BQ * (BK + 1);
  float* s_delta = s_lse + BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int qr = threadIdx.x / 32, dc = threadIdx.x % 32;  // rows qr*8+i, cols dc+32c

  // key tiles that any row of this query tile can see
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  load_tile<D>(sq, q, b, q0, Sq, H, h);
  load_tile<D>(sdo, dout, b, q0, Sq, H, h);
  load_rows(s_lse, s_delta, lse, delta, b, h, q0, Sq, H);
  float acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile consumed (Q and dO staged)
    load_tile<D>(sk, k, b, k0, Sk, K, kh);
    load_tile<D>(sv, v, b, k0, Sk, K, kh);
    __syncthreads();
    scores<D>(sq, sdo, sk, sv, s_lse, s_delta, nullptr, s_ds, q0, k0, Sq, Sk, causal, window,
              scale_log2);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float ds[8], kk[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) ds[i] = s_ds[(qr * 8 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = sk[j * (D + 1) + dc + 32 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += ds[i] * kk[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + qr * 8 + i;
    if (qi >= Sq) continue;
    const size_t off = (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[off + dc + 32 * c] = acc[i][c] * scale;
  }
}

// ------------------------------------------------------------ bf16, wgmma

namespace tl = tile;

// Keep the compiler from reusing an A fragment's registers while a wgmma
// may still read them.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Shared memory of both passes, from a 1024-aligned base: the two tiles a
// block keeps (K, V or Q, dO), two stages of the two tiles it streams, 2 x
// 128 floats of staged lse and delta (dK/dV pass), three mbarriers (the kept
// tiles, then one a stage), and the alignment slack.
template <int D>
constexpr size_t bwd_smem() {
  return 1024 + (size_t)6 * tl::tile_bytes(D) + 2 * 128 * sizeof(float) + 3 * 8;
}

// x (64 x 64, fp32) = A B^T and y = C E^T, the four tiles at shared
// addresses a, b, c, e (64 x D each, K-major), as two commit groups: x's,
// then y's.  x and y start at zero.
template <int D>
__device__ __forceinline__ void two_products(float (&x)[32], float (&y)[32], uint32_t a,
                                             uint32_t b, uint32_t c, uint32_t e) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
  tl::fence_regs(x);
  tl::fence_regs(y);
  __syncwarp();  // wgmma is .aligned: the warp's threads issue it together
  tl::wgmma_fence();
  tl::ss_product<D>(x, a, b);
  tl::wgmma_commit();
  tl::ss_product<D>(y, c, e);
  tl::wgmma_commit();
}

// Does the 64 x 64 tile (queries q0.., keys k0..) need its mask applied?
__device__ __forceinline__ bool edge_tile(int q0, int k0, int Sq, int Sk, int causal,
                                          int window) {
  return q0 + BQ > Sq || k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
         (window >= 0 && k0 <= q0 + BQ - 1 - window);
}

template <int D>
__global__ void __launch_bounds__(128) dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
    int K, int causal, int window, float scale, float scale_log2) {
  using T = tl::Tile<D>;
  constexpr int TB = tl::tile_bytes(D), SW = tl::swizzle_bytes(D), PW = SW / 2;
  static_assert(tl::tile_dim(D) == D, "head_dim 64 or 128: whole panels");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = tl::aligned_smem(smem_raw);
  const uint32_t sk = tl::smem_u32(sm), sv = sk + TB, stages = sk + 2 * TB;
  float* rows = reinterpret_cast<float*>(sm + 6 * TB);  // [stage][lse 64, delta 64]
  const uint32_t bars = tl::smem_u32(rows + 256);       // kept tiles, then stage 0, 1
  const int tid = threadIdx.x;
  const int b = blockIdx.x / K, kh = blockIdx.x % K, G = H / K;
  const int k0 = blockIdx.y * BK;  // the causally heaviest tiles come first

  // query tiles that can see any of these keys, for each of the G heads
  const int q_first = causal ? k0 : 0;
  const int q_end = window >= 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int nq = q_end > q_first ? (q_end - q_first + BQ - 1) / BQ : 0;
  const int n = G * nq;

  auto issue = [&](int i) {  // one thread: tile i's Q and dO into stage i % 2
    const int h = kh * G + i / nq, q0 = q_first + i % nq * BQ;
    const uint32_t st = stages + (i & 1) * 2 * TB, bar = bars + 8 + (i & 1) * 8;
    tl::mbar_expect_tx(bar, 2 * TB);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tl::tma_load_4d(st + p * BK * SW, &qmap, bar, p * PW, h, q0, b);
      tl::tma_load_4d(st + TB + p * BK * SW, &dmap, bar, p * PW, h, q0, b);
    }
  };
  auto stage_rows = [&](int i) {  // every thread: one of tile i's 64 lse and 64 delta
    const int h = kh * G + i / nq, q0 = q_first + i % nq * BQ;
    const size_t at = ((size_t)b * H + h) * Sq + min(q0 + tid % BQ, Sq - 1);
    tl::cp_async4(tl::smem_u32(rows + (i & 1) * 128 + tid), (tid < BQ ? lse : delta) + at);
    tl::cp_async_commit();
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tl::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      tl::mbar_expect_tx(bars, 2 * TB);
#pragma unroll
      for (int p = 0; p < D / PW; ++p) {
        tl::tma_load_4d(sk + p * BK * SW, &kmap, bars, p * PW, kh, k0, b);
        tl::tma_load_4d(sv + p * BK * SW, &vmap, bars, p * PW, kh, k0, b);
      }
      issue(0);
    }
  }
  if (n > 0) stage_rows(0);

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const int r0 = k0 + T::row(0);  // this thread's two key rows: r0 and r0 + 8
  for (int i = 0; i < n; ++i) {
    tl::cp_async_wait_all();  // tile i's lse and delta (this thread's)
    __syncthreads();          // ... every thread's; tile i - 1 consumed
    if (i + 1 < n) {
      if (tid == 0) issue(i + 1);
      stage_rows(i + 1);
    }
    if (i == 0) tl::mbar_wait(bars, 0);
    tl::mbar_wait(bars + 8 + (i & 1) * 8, (i >> 1) & 1);
    const uint32_t sq = stages + (i & 1) * 2 * TB, sdo = sq + TB;
    const float* s_lse = rows + (i & 1) * 128;
    const float* s_delta = s_lse + BQ;
    const int q0 = q_first + i % nq * BQ;
    const bool edge = edge_tile(q0, k0, Sq, Sk, causal, window);

    float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
    two_products<D>(s, dp, sk, sq, sv, sdo);
    tl::wgmma_wait<1>();  // S^T landed; dP^T still in flight
    tl::fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        const bool vis = !edge || visible(q0 + c, r0 + 8 * (e >> 1), Sq, Sk, causal, window);
        s[4 * j + e] = vis ? exp2f(fmaf(s[4 * j + e], scale_log2, -s_lse[c] * LOG2E)) : 0.f;
      }
    tl::wgmma_wait<0>();
    tl::fence_regs(dp);
    uint32_t fp[4][4], fd[4][4];
    tl::pack_frags(fp, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - s_delta[T::col(j, e)]);
    tl::pack_frags(fd, dp);
    tl::fence_regs(acc_v);
    tl::fence_regs(acc_k);
    tl::wgmma_fence();
    tl::rs_product<D>(acc_v, fp, sdo);  // dV += P^T dO
    tl::rs_product<D>(acc_k, fd, sq);   // dK += dS^T Q
    tl::wgmma_commit();
    tl::wgmma_wait<0>();
    tl::fence_regs(acc_v);
    tl::fence_regs(acc_k);
    fence_frags(fp);
    fence_frags(fd);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = r0 + 8 * h;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kp) * K + kh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = T::col(j, 0);
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
          __floats2bfloat162_rn(acc_k[4 * j + 2 * h] * scale, acc_k[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
          __floats2bfloat162_rn(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
    float scale, float scale_log2) {
  using T = tl::Tile<D>;
  constexpr int TB = tl::tile_bytes(D), SW = tl::swizzle_bytes(D), PW = SW / 2;
  static_assert(tl::tile_dim(D) == D, "head_dim 64 or 128: whole panels");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = tl::aligned_smem(smem_raw);
  const uint32_t sq = tl::smem_u32(sm), sdo = sq + TB, stages = sq + 2 * TB;
  const uint32_t bars = sq + 6 * TB + 2 * 128 * sizeof(float);  // kept tiles, stage 0, 1
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first

  // key tiles that any row of this query tile can see
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto issue = [&](int i) {  // one thread: tile i's K and V into stage i % 2
    const uint32_t st = stages + (i & 1) * 2 * TB, bar = bars + 8 + (i & 1) * 8;
    tl::mbar_expect_tx(bar, 2 * TB);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tl::tma_load_4d(st + p * BK * SW, &kmap, bar, p * PW, kh, k_begin + i * BK, b);
      tl::tma_load_4d(st + TB + p * BK * SW, &vmap, bar, p * PW, kh, k_begin + i * BK, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) tl::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      tl::mbar_expect_tx(bars, 2 * TB);
#pragma unroll
      for (int p = 0; p < D / PW; ++p) {
        tl::tma_load_4d(sq + p * BK * SW, &qmap, bars, p * PW, h, q0, b);
        tl::tma_load_4d(sdo + p * BK * SW, &dmap, bars, p * PW, h, q0, b);
      }
      issue(0);
    }
  }
  // this thread's two query rows: r0 and r0 + 8, their lse (base 2) and delta
  const int r0 = q0 + T::row(0);
  float l2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const size_t at = ((size_t)b * H + h) * Sq + min(r0 + 8 * e, Sq - 1);
    l2[e] = lse[at] * LOG2E;
    dl[e] = delta[at];
  }
  __syncthreads();  // barriers initialised

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int k0 = k_begin + i * BK;
    if (i > 0) __syncthreads();  // tile i - 1 consumed: its stage takes tile i + 1
    if (tid == 0 && i + 1 < n) issue(i + 1);
    if (i == 0) tl::mbar_wait(bars, 0);
    tl::mbar_wait(bars + 8 + (i & 1) * 8, (i >> 1) & 1);
    const uint32_t skt = stages + (i & 1) * 2 * TB, svt = skt + TB;
    const bool edge = edge_tile(q0, k0, Sq, Sk, causal, window);

    float s[32], dp[32];  // S and dP: rows are queries, columns keys
    two_products<D>(s, dp, sq, skt, sdo, svt);
    tl::wgmma_wait<1>();
    tl::fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const bool vis =
            !edge || visible(r0 + 8 * hr, k0 + T::col(j, e), Sq, Sk, causal, window);
        s[4 * j + e] = vis ? exp2f(fmaf(s[4 * j + e], scale_log2, -l2[hr])) : 0.f;
      }
    tl::wgmma_wait<0>();
    tl::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
    uint32_t fd[4][4];
    tl::pack_frags(fd, dp);
    tl::fence_regs(acc);
    tl::wgmma_fence();
    tl::rs_product<D>(acc, fd, skt);  // dQ += dS K
    tl::wgmma_commit();
    tl::wgmma_wait<0>();
    tl::fence_regs(acc);
    fence_frags(fd);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = r0 + 8 * e;
    if (qi >= Sq) continue;
    const size_t off = (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + T::col(j, 0)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * e] * scale, acc[4 * j + 2 * e + 1] * scale);
  }
}

// delta, then the two passes: the CUDA-core kernels for float32, the wgmma
// kernels for bfloat16.
template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int Sq, int Sk,
           int H, int K, int causal, int window, float scale, cudaStream_t st) {
  const int rows = B * Sq * H, q_tiles = (Sq + 63) / 64, k_tiles = (Sk + 63) / 64;
  const float scale_log2 = scale * LOG2E;
  delta_kernel<T><<<(rows + 7) / 8, THREADS, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, Sq, H, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (sizeof(T) == 2) {
    CUtensorMap qmap, kmap, vmap, dmap;
    if (!tl::kv_map<D>(&qmap, q, B, Sq, H) || !tl::kv_map<D>(&kmap, k, B, Sk, K) ||
        !tl::kv_map<D>(&vmap, v, B, Sk, K) || !tl::kv_map<D>(&dmap, dout, B, Sq, H))
      return (int)cudaErrorInvalidValue;
    constexpr size_t smem = bwd_smem<D>();
    e = cudaFuncSetAttribute(dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    dkdv_wgmma_kernel<D><<<dim3(B * K, k_tiles), 128, smem, st>>>(
        qmap, kmap, vmap, dmap, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, K, causal, window, scale, scale_log2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dq_wgmma_kernel<D><<<dim3(B * H, q_tiles), 128, smem, st>>>(
        qmap, kmap, vmap, dmap, lse, delta, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, K,
        causal, window, scale, scale_log2);
    return (int)cudaGetLastError();
  } else {
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* tdo = static_cast<const float*>(dout);
    constexpr size_t smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
    e = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_q);
    if (e != cudaSuccess) return (int)e;
    dkdv_kernel<D><<<dim3(B * K, k_tiles), THREADS, smem_kv, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H,
        K, causal, window, scale, scale_log2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dq_kernel<D><<<dim3(B * H, q_tiles), THREADS, smem_q, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), Sq, Sk, H, K, causal, window,
        scale, scale_log2);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// Which kernels a call takes: 1 = dkdv_wgmma_kernel and dq_wgmma_kernel
// (bf16, tensor cores), 0 = dkdv_kernel and dq_kernel (float32, CUDA
// cores).  The dtype alone decides.
extern "C" int flash_attention_bwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D); lse (B, H, Sq)
// float32 from the forward (flash_attention.cu); delta (B, H, Sq) float32
// scratch.  All contiguous; Sq != Sk only with causal 0 and no window.  dtype: 0 = float32, 1 = bfloat16; D 64 or 128.
// window < 0 means no sliding window.  Returns cudaGetLastError() after the
// launches, or the error that refused one (cudaErrorInvalidValue for a
// tensor map the driver does not encode).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* delta, int B, int Sq, int Sk, int H, int K,
                                   int D, int causal, int window, float scale, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS \
  q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, K, causal, window, scale, st
  if (dtype == 0 && D == 64) return launch<float, 64>(BWD_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(BWD_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(BWD_ARGS);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
