// Flash-decode attention of T new query tokens against a dense or ring-buffer
// KV cache, for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (the TPU kernel _decode_kernel).  Same function: query row r = t*G + g of
// KV head kh sits at absolute position cache_len - T + t; cache slot j is
// visible iff 0 <= kv_pos[j] <= q_pos (and kv_pos[j] > q_pos - window when a
// window is given).  Stale speculative slots carry positions above the
// rewound cache_len and are masked, so rollback needs no cache rewrite.
// Masked scores are -1e30 (not -inf): a fully masked row averages V and
// stays finite, exactly like the TPU kernel and the plain version.
//
// Bound on this card: bytes.  Each launch must read the K and V cache once
// (main path: 2 * 8 rows * 512 slots * 8 heads * 128 * 2 B = 16.8 MB), i.e.
// about 5 us at 3.35 TB/s, against ~38 MFLOP of arithmetic.
//
// Design: one block per (kv head, batch row), so the T*G query rows that
// share a KV head (GQA) are packed into one block and every K/V tile is read
// from device memory once for all of them.  The block walks the cache in
// tiles of 64 slots staged in shared memory (as fp32; K rows padded to D+1
// floats so the score loop is free of bank conflicts), keeps an fp32 online
// softmax per row in shared memory, and writes the output in q's dtype.
// Shared memory is sized from T*G at launch and opts in above 48 KB.
// Known limit: only B*K blocks (64 on the main path) for 132 SMs; a
// split-KV pass with an LSE combine is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;        // cache slots per tile
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cache_len, const int* __restrict__ kv_pos,
    T* __restrict__ out, int n_tok, int H, int K, int S, int window, float scale) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K, TG = n_tok * G;
  extern __shared__ float smem[];
  float* sq = smem;                      // TG x D      scaled queries
  float* sacc = sq + TG * D;             // TG x D      output accumulator
  float* sk = sacc + TG * D;             // BK x (D+1)  K tile
  float* sv = sk + BK * (D + 1);         // BK x D      V tile
  float* ss = sv + BK * D;               // TG x BK     scores, then p
  float* sm = ss + TG * BK;              // TG          running max
  float* sl = sm + TG;                   // TG          running sum
  float* scorr = sl + TG;                // TG          this tile's rescale
  int* spos = reinterpret_cast<int*>(scorr + TG);  // BK slot positions
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int clen = cache_len[b];
  const size_t slot_stride = (size_t)K * D;
  const T* kb = k + (size_t)b * S * slot_stride + (size_t)kh * D;
  const T* vb = v + (size_t)b * S * slot_stride + (size_t)kh * D;

  for (int i = tid; i < TG * D; i += THREADS) {
    const int r = i / D, d = i % D, t = r / G, g = r % G;
    sq[i] = to_f(q[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d]) * scale;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < TG; r += THREADS) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const bool in = s0 + j < S;
      sk[j * (D + 1) + d] = in ? to_f(kb[(size_t)(s0 + j) * slot_stride + d]) : 0.f;
      sv[j * D + d] = in ? to_f(vb[(size_t)(s0 + j) * slot_stride + d]) : 0.f;
    }
    for (int j = tid; j < BK; j += THREADS)
      spos[j] = s0 + j < S ? kv_pos[(size_t)b * S + s0 + j] : -1;
    __syncthreads();

    // scores: a warp covers 32 slots of one row (q broadcast, K conflict-free)
    for (int i = tid; i < TG * BK; i += THREADS) {
      const int r = i / BK, j = i % BK;
      const float* qr = sq + r * D;
      const float* kj = sk + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kj[d];
      const int p = spos[j], q_pos = clen - n_tok + r / G;
      const bool ok = p >= 0 && p <= q_pos && (window < 0 || p > q_pos - window);
      // slots past S do not exist at all (-inf); masked slots are -1e30
      ss[i] = s0 + j >= S ? -INFINITY : (ok ? dot : NEG_INF);
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < TG; r += THREADS / 32) {
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
    for (int i = tid; i < TG * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * BK;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < BK; ++j) a += pr[j] * sv[j * D + d];
      sacc[i] = sacc[i] * scorr[r] + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < TG * D; i += THREADS) {
    const int r = i / D, d = i % D, t = r / G, g = r % G;
    store(out + (((size_t)b * n_tok + t) * H + kh * G + g) * D + d,
          sacc[i] / fmaxf(sl[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           const int* kv_pos, void* out, int B, int n_tok, int H, int K, int S,
           int window, float scale, cudaStream_t stream) {
  const int TG = n_tok * (H / K);
  const size_t smem = sizeof(float) * (2 * TG * D + BK * (D + 1) + BK * D + TG * BK + 3 * TG)
                      + sizeof(int) * BK;
  auto kern = decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(K, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      cache_len, kv_pos, static_cast<T*>(out), n_tok, H, K, S, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* cl,
               const int* pos, void* out, int B, int n_tok, int H, int K, int S,
               int window, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, cl, pos, out, B, n_tok, H, K, S, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, cl, pos, out, B, n_tok, H, K, S, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, cl, pos, out, B, n_tok, H, K, S, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D); k, v (B, S, K, D); cache_len (B,) int32; kv_pos (B, S) int32;
// out (B, T, H, D).  All contiguous.  dtype: 0 = float32, 1 = bfloat16.
// window < 0 means no sliding window.  Returns cudaGetLastError() after launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* cache_len, const int* kv_pos, void* out,
                                int B, int n_tok, int H, int K, int D, int S,
                                int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, cache_len, kv_pos, out, B, n_tok, H, K, S,
                             window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, cache_len, kv_pos, out, B, n_tok, H,
                                     K, S, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
