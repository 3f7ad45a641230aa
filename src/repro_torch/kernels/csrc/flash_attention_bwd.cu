// Flash attention backward (training) for NVIDIA Hopper (sm_90a).
//
// Replaces: what JAX differentiates on the TPU when training runs
// src/repro/kernels/flash_attention.py::flash_attention_pallas under
// jax.value_and_grad (src/repro/training/train_loop.py).  The reference has
// no custom_vjp; this kernel is the port's gradient of K2
// (flash_attention.cu), with its masking: causal, an optional sliding
// window, GQA through kv head h / G, keys past S absent.  Self-attention
// only (Sq = Sk = S, q_offset 0): training never sets another.
//
// FlashAttention-2's two passes, no atomics, so the result is deterministic:
//   delta_kernel  D[b, h, i] = rowsum(dO * O)                (B*S*H warps)
//   dkdv_kernel   one block per (b, kv head, 64-row KV tile): K and V stay
//                 in shared memory while it walks the query tiles that can
//                 see them, for each of the G query heads of that KV head,
//                 recomputing P = exp(S - lse) from the forward's lse and
//                 accumulating dV += P^T dO and dK += dS^T Q in registers,
//                 dS = P * (dP - D), dP = dO V^T;
//   dq_kernel     one block per (b, query head, 64-row query tile): Q and dO
//                 stay in shared memory while it walks the visible KV tiles,
//                 accumulating dQ += dS K.
// Every tile is staged in shared memory as float32 (rows padded to D+1
// floats); products run on the CUDA cores with float32 accumulation for
// float32 and bfloat16 inputs alike.  256 threads a block: the 64 x 64
// score tile is 4 x 4 a thread, the 64 x D accumulators 8 x D/32.
//
// Bound on this card: operations.  The training shape (B=4 S=2048 H=16 K=8
// D=128, causal) needs five 64-row products over the causal half, ~172
// GFLOP: ~0.17 ms at 989 TFLOP/s bf16 (from the shapes); this kernel does
// seven (S and dP are recomputed in both passes) on the CUDA cores, whose
// float32 peak is 67 TFLOP/s, and its inner loops are bound by shared-memory
// loads.  Moving the products to wgmma with TMA-fed tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]; warp w is row w
// of the (B, S, H) layout.
template <class T>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, int S, int H, int D, int rows) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= rows) return;  // whole warps
  const T* o = out + (size_t)w * D;
  const T* g = dout + (size_t)w * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(o[d]) * to_f(g[d]);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = w % H, i = (w / H) % S, b = w / (H * S);
    delta[((size_t)b * H + h) * S + i] = s;
  }
}

// Rows r0 .. r0+63 of head n of a (B, S, N, D) tensor into dst (64 x (D+1)
// floats); rows past S are zeros.
template <class T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int S, int N, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < S ? to_f(src[(((size_t)b * S + r0 + r) * N + n) * D + d]) : 0.f;
  }
}

// lse (scaled by log2 e) and delta of query rows q0 .. q0+63 of (b, h).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int b, int h, int q0,
                                          int S, int H) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const size_t i = ((size_t)b * H + h) * S + min(q0 + r, S - 1);
    s_lse[r] = lse[i] * LOG2E;
    s_delta[r] = delta[i];
  }
}

// One 64 x 64 tile of (query rows q0.., key rows k0..): recompute S = Q K^T
// and dP = dO V^T (thread (tr, tc) owns rows tr*4+i, columns tc+16c), then
// P = exp(S - lse), zero where masked, and dS = P * (dP - delta).  Writes dS
// to s_ds and, if s_p is not null, P to s_p (both 64 x 65).
template <int D>
__device__ __forceinline__ void scores(const float* sq, const float* sdo, const float* sk,
                                       const float* sv, const float* s_lse,
                                       const float* s_delta, float* s_p, float* s_ds, int q0,
                                       int k0, int S, int causal, int window,
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
      const int j = tc + 16 * c, kp = k0 + j;
      const bool vis = qp < S && kp < S && !(causal && kp > qp) &&
                       !(window >= 0 && kp <= qp - window);
      const float p = vis ? exp2f(s[i][c] * scale_log2 - s_lse[r]) : 0.f;
      if (s_p != nullptr) s_p[r * (BK + 1) + j] = p;
      s_ds[r * (BK + 1) + j] = p * (dp[i][c] - s_delta[r]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int K, int causal, int window,
    float scale, float scale_log2) {
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
  const int q_end = window >= 0 ? min(S, k0 + BK - 1 + window) : S;

  load_tile<T, D>(sk, k, b, k0, S, K, kh);
  load_tile<T, D>(sv, v, b, k0, S, K, kh);
  float acc_k[8][DC], acc_v[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = q_begin / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile consumed (K and V staged)
      load_tile<T, D>(sq, q, b, q0, S, H, h);
      load_tile<T, D>(sdo, dout, b, q0, S, H, h);
      load_rows(s_lse, s_delta, lse, delta, b, h, q0, S, H);
      __syncthreads();
      scores<D>(sq, sdo, sk, sv, s_lse, s_delta, s_p, s_ds, q0, k0, S, causal, window,
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
    if (kp >= S) continue;
    const size_t off = (((size_t)b * S + kp) * K + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + dc + 32 * c] = from_f<T>(acc_k[i][c] * scale);
      dv[off + dc + 32 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int H, int K, int causal, int window, float scale,
    float scale_log2) {
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
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  load_tile<T, D>(sq, q, b, q0, S, H, h);
  load_tile<T, D>(sdo, dout, b, q0, S, H, h);
  load_rows(s_lse, s_delta, lse, delta, b, h, q0, S, H);
  float acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile consumed (Q and dO staged)
    load_tile<T, D>(sk, k, b, k0, S, K, kh);
    load_tile<T, D>(sv, v, b, k0, S, K, kh);
    __syncthreads();
    scores<D>(sq, sdo, sk, sv, s_lse, s_delta, nullptr, s_ds, q0, k0, S, causal, window,
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
    if (qi >= S) continue;
    const size_t off = (((size_t)b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[off + dc + 32 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int S, int H,
           int K, int causal, int window, float scale, cudaStream_t st) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int rows = B * S * H;
  delta_kernel<T><<<(rows + 7) / 8, THREADS, 0, st>>>(static_cast<const T*>(out), tdo, delta,
                                                      S, H, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr size_t smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
  e = cudaFuncSetAttribute(dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (S + 63) / 64;
  const float scale_log2 = scale * LOG2E;
  dkdv_kernel<T, D><<<dim3(B * K, tiles), THREADS, smem_kv, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, K, causal,
      window, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<T, D><<<dim3(B * H, tiles), THREADS, smem_q, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, K, causal, window, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Which kernel a call takes: always the CUDA-core kernels (0).
extern "C" int flash_attention_bwd_route(int) { return 0; }

// q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, S, K, D); lse (B, H, S)
// float32 from the forward (flash_attention.cu); delta (B, H, S) float32
// scratch.  All contiguous.  dtype: 0 = float32, 1 = bfloat16; D 64 or 128.
// window < 0 means no sliding window.  Returns cudaGetLastError() after the
// launches, or the error that refused one.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* delta, int B, int S, int H, int K, int D,
                                   int causal, int window, float scale, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, out, dout, lse, dq, dk, dv, delta, B, S, H, K, causal, window, scale, st
  if (dtype == 0 && D == 64) return launch<float, 64>(BWD_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(BWD_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(BWD_ARGS);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
