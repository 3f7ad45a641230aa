// Flash attention (prefill) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas (the
// TPU kernel _attn_kernel).  Same function: causal or not, an optional
// sliding window, a q_offset continuation, GQA through kv head h / G with no
// KV repeat, and whole-tile skipping of fully masked KV tiles.  Keys past Sk
// do not exist (-inf); masked keys score -1e30, as on the TPU.
//
// Bound on this card: operations at long prompts, bytes at short ones.  The
// main path's largest call (B=4, S=512, H=16, D=128, causal) needs ~4.3
// GFLOP (~4.4 us at 989 TFLOP/s bf16) and moves ~25 MB (~7.5 us at 3.35
// TB/s); smaller buckets are bytes-bound.
//
// Design: one block of 128 threads per (64-row q tile, batch*head).  The q
// tile and each 64-key K/V tile are staged in shared memory as fp32 (rows
// padded to D+1 floats against bank conflicts).  Each thread owns an 8x4
// micro-tile of the scores and an 8 x D/16 slice of the output accumulator
// in registers, so every shared-memory read feeds several FMAs; row max and
// sum are reduced over the 16 threads that share a row with warp shuffles.
// The loop over KV tiles stops at the causal limit and starts at the window's
// first visible tile.  The products run on the CUDA cores in fp32: the tensor
// cores (wgmma) and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64, THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int K, int causal, int window,
    int q_offset, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  extern __shared__ float smem[];
  float* sq = smem;                 // BQ x (D+1)
  float* sk = sq + BQ * (D + 1);    // BK x (D+1)
  float* sv = sk + BK * (D + 1);    // BK x D
  float* sp = sv + BK * D;          // BQ x (BK+1)  probabilities
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;  // rows rg*8+i, cols cg+16c

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    sq[r * (D + 1) + d] =
        qi < Sq ? to_f(q[(((size_t)b * Sq + qi) * H + h) * D + d]) * scale : 0.f;
  }
  float acc[8][DC], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that any row of this q tile can see
  int k_end = Sk, k_begin = 0;
  if (causal) k_end = min(Sk, q_offset + q0 + BQ);
  if (window >= 0) k_begin = max(0, q_offset + q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile consumed (and q tile staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D, kj = k0 + j;
      const size_t off = (((size_t)b * Sk + kj) * K + kh) * D + d;
      sk[j * (D + 1) + d] = kj < Sk ? to_f(k[off]) : 0.f;
      sv[j * D + d] = kj < Sk ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = sq[(rg * 8 + i) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sk[(cg + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg * 8 + i, q_pos = q_offset + q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + cg + 16 * c;
        float x = s[i][c];
        if (kp >= Sk) x = -INFINITY;
        else if ((causal && kp > q_pos) || (window >= 0 && kp <= q_pos - window)) x = NEG_INF;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx), corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sp[r * (BK + 1) + cg + 16 * c] = p;
        sum += p;
      }
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sv[j * D + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = sp[(rg * 8 + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + rg * 8 + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(o + cg + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int K, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  auto kern = flash_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, K, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int K, int causal, int window, int q_offset,
               float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, K, causal, window, q_offset, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, K, causal, window, q_offset, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, K, causal, window, q_offset, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Sk, K, D); out (B, Sq, H, D).  All contiguous.
// dtype: 0 = float32, 1 = bfloat16.  window < 0 means no sliding window.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int Sq, int Sk, int H, int K, int D, int causal,
                               int window, int q_offset, float scale, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, B, Sq, Sk, H, K, causal, window, q_offset,
                             scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, K, causal, window,
                                     q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
